"""The decode kernel (``repro_torch.kernels.ops.decode_attention``) against
its plain version, ``models.layers.attention.decode_attention``.

On the CPU: the model's route takes the plain version bit for bit, the
kernel's wrapper refuses what the kernel does not take and any tensor off
the card, and the split rule fills the
card from the shapes alone.  On the card (marked ``cuda``, skipped without
one; JAX-free):

    python -m pytest -q -m cuda tests/test_torch_decode_attention.py

the kernel at each benchmark cell's decode shape, a window, a float32
cache, the int8 cache's dequantized K/V and a row with no valid slot, two
launches bit for bit, and olmo_1b's greedy tokens through the kernel
against the plain path's."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch
from repro_torch.kernels import decode_attention as decode
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.models.layers import attention as A

H100_SMS = 132


def inputs(b, c, kv, g, hd, dtype, seed, *, n_valid=None, pos=None, device="cpu"):
    """q (b, 1, kv*g, hd), caches (b, c, kv, hd) from a seeded generator;
    slot j holds position j for j < n_valid (default c - c // 8) and is
    empty (-1) after it; pos (default n_valid - c // 16 - 1) leaves the
    last slots before the empty ones past pos."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, kv * g, hd, generator=gen).to(dtype)
    k = torch.randn(b, c, kv, hd, generator=gen).to(dtype)
    v = torch.randn(b, c, kv, hd, generator=gen).to(dtype)
    n_valid = c - c // 8 if n_valid is None else n_valid
    kv_pos = torch.full((c,), -1, dtype=torch.int32)
    kv_pos[:n_valid] = torch.arange(n_valid, dtype=torch.int32)
    pos = n_valid - c // 16 - 1 if pos is None else pos
    dev = torch.device(device)
    return [t.to(dev) for t in (q, k, v, kv_pos, torch.tensor(pos, dtype=torch.int32))]


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("b,c,kv,g,hd,window,scale,dtype", [
    (2, 40, 4, 1, 32, 0, None, torch.float32),
    (2, 40, 2, 3, 64, 0, 0.0078125, torch.float32),
    (1, 33, 2, 4, 128, 16, None, torch.bfloat16),
    (3, 17, 1, 2, 48, 0, None, torch.bfloat16)])  # a head dim the kernel lacks
def test_cpu_takes_the_plain_version_bit_for_bit(b, c, kv, g, hd, window, scale, dtype):
    """The model's route (``T.decode_attention``) takes the plain version
    on the CPU and launches nothing."""
    q, k, v, kv_pos, pos = inputs(b, c, kv, g, hd, dtype, seed=c + hd)
    before = ops.COUNTS["decode_attention"].launches
    got = T.decode_attention(q, k, v, kv_pos, pos, window=window, scale=scale)
    want = A.decode_attention(q, k, v, kv_pos, pos, window=window, scale=scale)
    assert got.dtype == dtype and torch.equal(got, want)
    assert ops.COUNTS["decode_attention"].launches == before


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrapper_refuses_a_tensor_off_the_card(device):
    """The wrapper has no plain branch: the kernel or a refusal."""
    q, k, v, kv_pos, pos = (t.to(device) for t in
                            inputs(1, 16, 2, 1, 64, torch.bfloat16, seed=5))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(q, k, v, kv_pos, pos)


def test_block_decode_on_cpu_matches_plain_attention():
    """``block_decode`` routes through ``T.decode_attention``, which on the
    CPU is the plain version: its output equals the same layer computed with
    ``A.decode_attention`` by hand."""
    cfg = dataclasses.replace(get_config("olmo_1b").scaled_down(), dtype="float32")
    params = get_model(cfg, "cpu").init(0)
    lp = params["layers"][0]
    cache = T.init_cache(cfg, 2, 8, "cpu")
    lcache = {key: cache["full"][key][0] for key in ("k", "v", "kv_pos")}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(3))
    pos = torch.tensor(0, dtype=torch.int32)
    got, new = T.block_decode(cfg, lp, x, lcache, pos, "full")
    h = T.B.apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    q, _k, _v = A.qkv(lp["attn"], h, cfg, pos.reshape(1))
    o = A.decode_attention(q, new["k"], new["v"], new["kv_pos"], pos).reshape(2, 1, cfg.q_dim)
    want = T._mix(cfg, lp, x, o, aux=False)[0]
    assert torch.equal(got, want)


def test_wrapper_refuses_a_head_dim_it_was_not_built_for():
    q, k, v, kv_pos, pos = inputs(1, 16, 2, 1, 48, torch.bfloat16, seed=1)
    with pytest.raises(NotImplementedError, match="head_dim"):
        decode.decode_attention_cuda(q, k, v, kv_pos, pos)


def test_wrapper_refuses_mixed_dtypes():
    q, k, v, kv_pos, pos = inputs(1, 16, 2, 1, 64, torch.bfloat16, seed=2)
    with pytest.raises(ValueError, match="share"):
        decode.decode_attention_cuda(q.float(), k, v, kv_pos, pos)
    with pytest.raises(ValueError, match="share"):
        decode.decode_attention_cuda(q, k, v.float(), kv_pos, pos)


def test_wrapper_refuses_a_non_contiguous_cache():
    q, k, v, kv_pos, pos = inputs(2, 16, 2, 1, 64, torch.bfloat16, seed=3)
    strided = k.transpose(0, 1).contiguous().transpose(0, 1)  # (B, C, KV, hd), C outermost
    assert strided.shape == k.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        decode.decode_attention_cuda(q, strided, v, kv_pos, pos)


@pytest.mark.parametrize("change,match", [
    (lambda a: {**a, "q": a["q"].repeat(1, 1, 5, 1)[:, :, :18]}, "groups"),  # 9 a KV head
    (lambda a: {**a, "kv_positions": a["kv_positions"].long()}, "int32"),
    (lambda a: {**a, "pos": 3}, "pos"),
    (lambda a: {**a, "q": a["q"].expand(2, 2, 4, 64)}, "B, 1, H, hd")])
def test_wrapper_refuses_other_arguments(change, match):
    q, k, v, kv_pos, pos = inputs(2, 16, 2, 2, 64, torch.float32, seed=4)
    args = change({"q": q, "k_cache": k, "v_cache": v, "kv_positions": kv_pos, "pos": pos})
    with pytest.raises(ValueError, match=match):
        decode.decode_attention_cuda(**args)


#: each cell's decode shape (B * KV pairs, C slots) and the splits the rule
#: gives on an H100's 132 SMs
CELLS = {"olmo_1b.chat": (32 * 16, 640, 1), "olmo_1b.preempt": (2 * 16, 384, 3),
         "granite_moe_3b.long_prompt": (4 * 8, 3968, 17),
         "granite_h_small.rag_8k": (2 * 8, 8320, 33)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_split_rule_fills_the_card_from_the_shapes(cell):
    pairs, slots, want = CELLS[cell]
    splits = decode.split_count(pairs, slots, H100_SMS)
    assert splits == want == decode.split_count(pairs, slots, H100_SMS)
    assert pairs * splits >= H100_SMS or splits == slots // decode.MIN_SPLIT_SLOTS
    if splits > 1:  # the kernel's ceil(C / splits) slots a split: none empty, none short
        per = math.ceil(slots / splits)
        assert (splits - 1) * per < slots and slots - (splits - 1) * per >= 1
        assert per >= decode.MIN_SPLIT_SLOTS


def test_split_rule_depends_on_shapes_alone():
    """Never more blocks than about BLOCKS_PER_SM an SM, never a split
    shorter than MIN_SPLIT_SLOTS, and no split once the pairs fill the
    SMs, over a sweep of shapes; the rule takes no position."""
    for sms in (1, 78, 132):
        for pairs in (1, 2, 7, 16, 64, 131, 132, 600):
            for slots in (1, 127, 128, 640, 8320, 70000):
                s = decode.split_count(pairs, slots, sms)
                assert s >= 1
                if pairs >= sms:
                    assert s == 1
                elif s > 1:
                    assert pairs * s < (decode.BLOCKS_PER_SM * sms + pairs)
                    assert slots // s >= decode.MIN_SPLIT_SLOTS
                    assert (s - 1) * math.ceil(slots / s) < slots


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def plain32(q, k, v, kv_pos, pos, **kw):
    """The plain version in float32 throughout (q taken to float32; it
    takes the caches to float32 itself)."""
    return A.decode_attention(q.float(), k, v, kv_pos, pos, **kw)


def assert_close_to_plain(got, q, k, v, kv_pos, pos, **kw):
    """bf16 output: within the rounding to bf16 of the float32 value (half
    an ulp, at most 2^-8 of it) plus float32 sums taken in another order
    (~1e-6): rtol 2^-8, atol 1e-5.  float32 output: sums over up to 8,320 slots reassociated
    and the online softmax's rescalings: rtol 2e-5, atol 2e-6."""
    want = plain32(q, k, v, kv_pos, pos, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape and got.is_cuda
    if q.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


#: each cell's decode shape: (B, C, KV, G, hd, scale)
CELL_SHAPES = {"olmo_1b.chat": (32, 640, 16, 1, 128, None),
               "granite_moe_3b.long_prompt": (4, 3968, 8, 3, 64, None),
               "granite_h_small.rag_8k": (2, 8320, 8, 4, 128, 0.0078125),
               "olmo_1b.preempt": (2, 384, 16, 1, 128, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_kernel_matches_plain_at_each_cell_shape(cuda_device, cell, dtype):
    b, c, kv, g, hd, scale = CELL_SHAPES[cell]
    q, k, v, kv_pos, pos = inputs(b, c, kv, g, hd, dtype, seed=c, device=cuda_device)
    assert (kv_pos > pos).any() and (kv_pos < 0).any()
    splits = decode.split_count(b * kv, c, decode.sm_count(torch.cuda.current_device()))
    count = ops.COUNTS["decode_attention"]
    key = (b, c, kv, g, hd, splits, str(dtype).removeprefix("torch."))
    before, before_key = count.launches, count.shapes.get(key, 0)
    got = ops.decode_attention(q, k, v, kv_pos, pos, scale=scale)
    torch.cuda.synchronize()
    assert count.launches == before + 1 and count.shapes[key] == before_key + 1
    assert_close_to_plain(got, q, k, v, kv_pos, pos, scale=scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,kv,g,hd", [(2, 512, 4, 2, 256), (3, 96, 8, 1, 32),
                                         (1, 4096, 2, 8, 64)])
def test_kernel_masks_a_window(cuda_device, b, c, kv, g, hd):
    """A ring cache full past its window and one with stale and future
    positions scattered over it: only kv_pos in (pos - window, pos] count."""
    q, k, v, _kp, _p = inputs(b, c, kv, g, hd, torch.bfloat16, seed=hd, device=cuda_device)
    pos_val, window = 3 * c + 5, c // 2
    ring = torch.arange(pos_val - c + 1, pos_val + 1, dtype=torch.int32)
    ring = torch.roll(ring, shifts=(pos_val + 1) % c)  # position p at slot p % c
    rng = np.random.default_rng(c)
    scattered = torch.from_numpy(rng.integers(pos_val - 2 * c, pos_val + 8, size=c)
                                 .astype(np.int32))
    scattered[rng.random(c) < 0.2] = -1
    pos = torch.tensor(pos_val, dtype=torch.int32, device=cuda_device)
    for kv_pos in (ring, scattered):
        kv_pos = kv_pos.to(cuda_device)
        got = ops.decode_attention(q, k, v, kv_pos, pos, window=window)
        assert_close_to_plain(got, q, k, v, kv_pos, pos, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,kv,g,hd", [(3, 1000, 4, 2, 32), (2, 300, 2, 6, 256)])
def test_kernel_on_a_float32_cache(cuda_device, b, c, kv, g, hd):
    q, k, v, kv_pos, pos = inputs(b, c, kv, g, hd, torch.float32, seed=7, device=cuda_device)
    got = ops.decode_attention(q, k, v, kv_pos, pos)
    assert_close_to_plain(got, q, k, v, kv_pos, pos)


@pytest.mark.cuda
def test_kernel_on_the_int8_caches_dequantized_kv(cuda_device):
    """``block_decode``'s ``cache_quant`` branch: int8 K/V times bf16 scales
    in float32, one rounding to bf16, then the kernel."""
    b, c, kv, g, hd = 4, 640, 8, 2, 128
    q, k, v, kv_pos, pos = inputs(b, c, kv, g, hd, torch.bfloat16, seed=8, device=cuda_device)
    (kq, ks), (vq, vs) = T._quantize_kv(k), T._quantize_kv(v)
    kd = (kq.float() * ks.float()).to(q.dtype)
    vd = (vq.float() * vs.float()).to(q.dtype)
    got = ops.decode_attention(q, kd, vd, kv_pos, pos)
    assert_close_to_plain(got, q, kd, vd, kv_pos, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,kv,g,hd", [(32, 640, 16, 1, 128), (2, 8320, 8, 4, 128)])
def test_kernel_row_with_no_valid_slot_is_the_plain_uniform_softmax(cuda_device, b, c, kv,
                                                                   g, hd):
    """No slot valid (every position past pos): the plain version's
    softmax over scores all -1e30 is uniform, the mean of V; one block a
    pair and a split pair alike."""
    q, k, v, kv_pos, _ = inputs(b, c, kv, g, hd, torch.bfloat16, seed=9, device=cuda_device)
    pos = torch.tensor(-1, dtype=torch.int32, device=cuda_device)
    got = ops.decode_attention(q, k, v, kv_pos, pos)
    assert_close_to_plain(got, q, k, v, kv_pos, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["olmo_1b.chat", "granite_h_small.rag_8k"])
def test_two_launches_give_the_same_bits(cuda_device, cell):
    b, c, kv, g, hd, scale = CELL_SHAPES[cell]
    args = inputs(b, c, kv, g, hd, torch.bfloat16, seed=10, device=cuda_device)
    first = ops.decode_attention(*args, scale=scale)
    for _ in range(3):
        assert torch.equal(ops.decode_attention(*args, scale=scale), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_olmo_greedy_tokens_through_the_kernel_equal_the_plain_path(cuda_device,
                                                                    monkeypatch, dtype):
    """olmo_1b at full width, a chat-shaped batch (4 x 64 prompt tokens, 16
    greedy steps): the tokens through the kernel, 16 launches a step (one a
    layer), equal those of the plain version on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("olmo_1b"), dtype=dtype)
    model = get_model(cfg, cuda_device)
    params = model.init(0)
    batch = make_batch(cfg, ShapeConfig("t", 64, 4, "prefill"))
    count = ops.COUNTS["decode_attention"]

    def greedy():
        with torch.inference_mode():
            logits, cache = model.prefill(params, batch)
            toks = []
            for _ in range(16):
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(token)
                before = count.launches
                logits, cache = model.decode_step(params, cache, token)
                launched = count.launches - before
            return torch.cat(toks, dim=1).cpu(), launched

    kernel, launched = greedy()
    assert launched == cfg.n_layers == 16
    monkeypatch.setattr(ops, "decode_attention", A.decode_attention)
    plain, launched = greedy()
    assert launched == 0
    assert torch.equal(kernel, plain)
