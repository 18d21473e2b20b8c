"""The port's CUDA kernels against their plain versions, the model's
prefill through the flash kernel against the CPU's plain path, and the DES
workloads' reports with every Erda verify on the card against the CPU's.
JAX-free, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each test skips where there is no CUDA device."""
import dataclasses
import zlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ServerConfig, layout, make_store
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref
from repro_torch.models import get_model
from repro_torch.tree import map_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,w", [(1, 1), (4, 16), (32, 64), (128, 7),
                                 (1000, 3), (512, 256), (65, 4097),
                                 # the kernel's chunk (8192 words) boundaries
                                 (3, 8188), (3, 8189), (3, 8191), (3, 8192),
                                 (3, 8193), (2, 16385)])
def test_crc32_kernel_matches_plain_and_zlib(cuda_device, n, w):
    data = np.random.default_rng(n * 100 + w).integers(
        0, 2**32, size=(n, w), dtype=np.uint32)
    words = torch.from_numpy(data.view(np.int32)).to(cuda_device)
    before = ops.COUNTS["crc32_batch"].launches
    got = ops.crc32_batch(words)
    assert ops.COUNTS["crc32_batch"].launches == before + 1
    assert got.is_cuda and torch.equal(got, ref.crc32_ref(words))
    assert got.cpu().tolist() == [zlib.crc32(r.tobytes()) for r in data]


def test_crc32_kernel_long_row_matches_zlib(cuda_device):
    """One 16 MiB row (2048 chunks) and rows of 4 MiB + 12 B, each starting
    at another 16-byte phase: against zlib (the plain version's per-byte
    loop is too slow at this width)."""
    rng = np.random.default_rng(16)
    for n, w in [(1, 1 << 22), (5, 1048579)]:
        data = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
        got = ops.crc32_batch(torch.from_numpy(data.view(np.int32)).to(cuda_device))
        assert got.cpu().tolist() == [zlib.crc32(r.tobytes()) for r in data]


def test_verify_records_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(0)
    bufs = []
    for n in (0, 5, 64, 1000):
        rec = layout.pack_record(int(rng.integers(1, 2**62)), rng.bytes(n))
        flip = bytearray(rec)
        flip[-1] ^= 4
        bufs += [rec, rec[:-2], bytes(flip), rec + bytes(7)]
    bufs.append(layout.pack_record(9, None, delete=True))
    np.testing.assert_array_equal(layout.verify_records(bufs, cuda_device),
                                  layout.verify_records(bufs, "cpu"))


def test_store_round_trip_on_card(cuda_device):
    s = make_store("erda-cluster", n_shards=2, replication=2,
                   cfg=ServerConfig(device_size=4 << 20, table_capacity=1 << 9,
                                    n_heads=2, region_size=256 << 10,
                                    segment_size=32 << 10))
    s.multi_write([(k, bytes([k]) * k) for k in range(1, 40)])
    before = ops.COUNTS["crc32_batch"].launches
    assert s.multi_read(list(range(1, 40))) == [bytes([k]) * k for k in range(1, 40)]
    assert ops.COUNTS["crc32_batch"].launches > before


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 100, 192, 512, 2048])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_flash_kernel_matches_plain(cuda_device, hd, s, dtype, tol, causal):
    rng = np.random.default_rng(hd * 1000 + s)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, 3, hd)).astype(np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    before = ops.COUNTS["flash_attention"].launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.COUNTS["flash_attention"].launches == before + 1
    torch.cuda.synchronize()
    fold = lambda t: t.movedim(2, 1).reshape(6, s, hd)
    want = ref.attention_ref(fold(q), fold(k), fold(v), causal=causal)
    assert got.dtype == dtype and got.is_cuda
    err = (fold(got).float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-5)])
@pytest.mark.parametrize("s", [65, 512, 8192])
def test_flash_kernel_takes_the_scale(cuda_device, s, dtype, tol):
    """µP's softmax scale (granite 4.0-H: 0.0078125, not 1/sqrt(128)) reaches
    the kernel: its output is the plain path's at that scale, and another
    output than at the default scale."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, 2, 128)).astype(np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True, scale=0.0078125)
    default = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    fold = lambda t: t.movedim(2, 1).reshape(2, s, 128)
    want = ref.attention_ref(fold(q), fold(k), fold(v), causal=True, scale=0.0078125)
    assert (fold(got).float() - want.float()).abs().max().item() <= tol
    assert (fold(default).float() - want.float()).abs().max().item() > 10 * tol


def test_rope_frequencies_on_card_are_the_cpus(cuda_device):
    """The card rotates by the CPU's frequencies, bit for bit: the two
    devices' pow differ in the last place, which position p multiplies."""
    from repro_torch.models.layers.basic import rope_frequencies
    cpu = rope_frequencies(256, 1_000_000.0, torch.device("cpu"))
    card = rope_frequencies(256, 1_000_000.0, cuda_device)
    assert card.is_cuda and torch.equal(card.cpu(), cpu)


def test_flash_routes_are_counted_by_dtype(cuda_device):
    """A bf16 call advances the tensor-core (wgmma) route's count, an f32
    call the CUDA-core route's."""
    count = ops.COUNTS["flash_attention"]
    q = torch.randn(1, 64, 2, 64, device=cuda_device)
    before = flash.launches_by_route(count.shapes)
    ops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    mid = flash.launches_by_route(count.shapes)
    assert mid == {"wgmma": before["wgmma"] + 1, "cuda_core": before["cuda_core"]}
    ops.flash_attention(q, q, q)
    after = flash.launches_by_route(count.shapes)
    assert after == {"wgmma": mid["wgmma"], "cuda_core": mid["cuda_core"] + 1}


def test_model_prefill_on_card_matches_cpu(cuda_device):
    """olmo_1b scaled down, float32: prefill on the card launches the flash
    kernel once a layer and matches the CPU's plain path within 3e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("olmo_1b").scaled_down(), dtype="float32")
    params = get_model(cfg, "cpu").init(0)
    batch = make_batch(cfg, ShapeConfig("t", 40, 2, "prefill"))
    with torch.inference_mode():
        want, _ = get_model(cfg, "cpu").prefill(params, batch)
        before = ops.COUNTS["flash_attention"].launches
        got, cache = get_model(cfg, cuda_device).prefill(
            map_leaves(lambda t: t.to(cuda_device), params), batch)
    assert ops.COUNTS["flash_attention"].launches == before + cfg.n_layers
    assert cache["full"]["k"].is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("seq,remat", [(40, "none"), (40, "full"), (640, "full")])
def test_train_step_on_card_matches_cpu(cuda_device, seq, remat):
    """olmo_1b scaled down, float32: one train step's loss and every
    gradient on the card match the CPU within 3e-5 (S = 640 takes chunked
    attention), and training launches no flash kernel."""
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import flatten_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("olmo_1b").scaled_down(), dtype="float32",
                              remat=remat, attn_chunk=128)
    params = get_model(cfg, "cpu").init(0)
    batch = make_batch(cfg, ShapeConfig("t", seq, 2, "train"))
    want_l, want_g = loss_and_grads(get_model(cfg, "cpu").train_loss, params, batch)
    before = ops.COUNTS["flash_attention"].launches
    got_l, got_g = loss_and_grads(get_model(cfg, cuda_device).train_loss,
                                  map_leaves(lambda t: t.to(cuda_device), params), batch)
    assert ops.COUNTS["flash_attention"].launches == before
    assert got_l.is_cuda
    np.testing.assert_allclose(got_l.item(), want_l.item(), rtol=3e-5, atol=3e-5)
    for (p, a), (_q, b) in zip(flatten_with_path(got_g), flatten_with_path(want_g)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=3e-5, atol=3e-5,
                                   err_msg=p)


def test_flash_wrapper_refuses_gradients_on_card(cuda_device):
    q = torch.randn(1, 64, 2, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q, q)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).shape == q.shape


def test_trainer_resumes_on_card(cuda_device):
    """``launch.train.train`` at the smoke scale on the card: checkpoint at
    step 4, a fresh trainer resumes through the CRC kernel and repeats
    steps 5-6 with the same losses."""
    from repro_torch.launch.train import train
    ops.reset_counts()
    _s, losses_a, mgr = train(steps=6, batch=2, seq=32, ckpt_every=4, log_every=0,
                              device=cuda_device)
    _s, losses_b, _ = train(steps=6, batch=2, seq=32, resume=True, ckpt_mgr=mgr,
                            log_every=0, device=cuda_device)
    assert losses_b == pytest.approx(losses_a[-2:], rel=1e-4)
    assert ops.COUNTS["crc32_batch"].launches > 0
    assert ops.COUNTS["flash_attention"].launches == 0


def lg_config(**kw):
    """gemma3's scaled-down local_global config with its two-layer tail,
    float32 (window 64)."""
    return dataclasses.replace(get_config("gemma3_27b").scaled_down(), n_layers=8,
                               dtype="float32", **kw)


@pytest.mark.parametrize("arch,kw,seq,flash_layers", [
    ("gemma3_27b", {"n_layers": 8}, 160, 1),  # past the window: globals only
    ("gemma3_27b", {"n_layers": 8}, 48, 8),   # inside it: every layer
    ("pixtral_12b", {}, 24, 4),
    ("olmo_1b", {"attn_pattern": "swa", "window": 64}, 100, 0),
    # head_dim 256 on the global layer (the f32 CUDA-core route)
    ("gemma3_12b", {"head_dim": 256, "n_layers": 8}, 160, 1),
    # MoE: k = 8 in groups of 16; mixtral's swa past its window
    ("granite_moe_3b", {"n_experts": 16, "n_experts_active": 8, "moe_group": 16}, 64, 4),
    ("mixtral_8x22b", {}, 100, 0)])
def test_pattern_prefill_and_decode_on_card_match_cpu(cuda_device, arch, kw, seq,
                                                      flash_layers):
    """Prefill and four decode steps of each pattern and of MoE, f32, on the
    card against the CPU within 3e-5.  A window layer longer than its window
    never reaches the flash kernel; one inside it may."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype="float32", **kw)
    params = get_model(cfg, "cpu").init(0)
    batch = make_batch(cfg, ShapeConfig("t", seq, 2, "prefill"))
    runs = []
    before = ops.COUNTS["flash_attention"].launches
    with torch.inference_mode():
        for dev in (cuda_device, torch.device("cpu")):
            model = get_model(cfg, dev)
            p = map_leaves(lambda t: t.to(dev), params)
            logits, cache = model.prefill(p, batch)
            if dev.type == "cuda":
                assert ops.COUNTS["flash_attention"].launches == before + flash_layers
            outs = [logits]
            for _ in range(4):
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                logits, cache = model.decode_step(p, cache, token)
                outs.append(logits)
            runs.append(outs)
    for a, b in zip(*runs):
        torch.testing.assert_close(a.cpu(), b, rtol=3e-5, atol=3e-5)


def test_int8_decode_on_card_matches_cpu(cuda_device):
    """The int8 cache replay on the card against the CPU: logits within
    3e-5 over 8 steps, int8 K/V with bf16 scales."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lg_config(cache_quant=True)
    params = get_model(cfg, "cpu").init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32))
    runs = []
    with torch.inference_mode():
        for dev in (cuda_device, torch.device("cpu")):
            model = get_model(cfg, dev)
            p = map_leaves(lambda t: t.to(dev), params)
            cache, outs = model.init_cache(2, 0), []
            for t in range(8):
                logits, cache = model.decode_step(p, cache, toks[:, t:t + 1].to(dev))
                outs.append(logits)
            assert cache["full"]["k"].dtype == torch.int8 and cache["full"]["k"].device.type == dev.type
            runs.append(outs)
    for a, b in zip(*runs):
        torch.testing.assert_close(a.cpu(), b, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("arch,kw,seq", [
    ("gemma3_27b", {"n_layers": 8}, 160), ("pixtral_12b", {}, 24),
    ("granite_moe_3b", {"n_experts": 16, "n_experts_active": 8, "moe_group": 16}, 64),
    ("mixtral_8x22b", {}, 100)])
def test_pattern_train_step_on_card_matches_cpu(cuda_device, arch, kw, seq):
    """local_global (banded attention, group remat), vlm and MoE (the aux
    loss in the loss): the loss and every gradient on the card match the
    CPU within 3e-5, with no flash launch."""
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import flatten_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype="float32",
                              remat="full", **kw)
    params = get_model(cfg, "cpu").init(0)
    batch = make_batch(cfg, ShapeConfig("t", seq, 2, "train"))
    want_l, want_g = loss_and_grads(get_model(cfg, "cpu").train_loss, params, batch)
    before = ops.COUNTS["flash_attention"].launches
    got_l, got_g = loss_and_grads(get_model(cfg, cuda_device).train_loss,
                                  map_leaves(lambda t: t.to(cuda_device), params), batch)
    assert ops.COUNTS["flash_attention"].launches == before
    np.testing.assert_allclose(got_l.item(), want_l.item(), rtol=3e-5, atol=3e-5)
    for (p, a), (_q, b) in zip(flatten_with_path(got_g), flatten_with_path(want_g)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=3e-5, atol=3e-5,
                                   err_msg=p)


#: the rwkv, hybrid (with a tail), encdec and hybrid_moe families:
#: scaled-down config overrides, prompt length, and the flash launches a
#: prefill makes
FAMILIES = [("rwkv6_1p6b", {}, 40, 0),
            ("zamba2_1p2b", {"n_layers": 5, "shared_attn_every": 2}, 40, 2),
            ("whisper_small", {}, 24, 2 + 4),  # 2 encoder + 4 decoder layers
            ("granite_h_small", {"n_layers": 4, "layer_types": ("mamba", "attention") * 2},
             40, 2)]


@pytest.mark.parametrize("arch,kw,seq,flash_calls", FAMILIES)
def test_family_prefill_and_decode_on_card_match_cpu(cuda_device, arch, kw, seq,
                                                     flash_calls):
    """Prefill (the shared block's and the encoder's and decoder's
    self-attention through the flash kernel) and four decode steps, f32, on
    the card against the CPU within 3e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype="float32", **kw)
    params = get_model(cfg, "cpu").init(0)
    batch = make_batch(cfg, ShapeConfig("t", seq, 2, "prefill"))
    runs = []
    with torch.inference_mode():
        for dev in (cuda_device, torch.device("cpu")):
            model = get_model(cfg, dev)
            p = map_leaves(lambda t: t.to(dev), params)
            before = ops.COUNTS["flash_attention"].launches
            logits, cache = model.prefill(p, batch)
            if dev.type == "cuda":
                assert ops.COUNTS["flash_attention"].launches == before + flash_calls
            outs = [logits]
            for _ in range(4):
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                logits, cache = model.decode_step(p, cache, token)
                outs.append(logits)
            runs.append(outs)
    for a, b in zip(*runs):
        torch.testing.assert_close(a.cpu(), b, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("arch,kw,seq,_flash", FAMILIES)
def test_family_train_step_on_card_matches_cpu(cuda_device, arch, kw, seq, _flash):
    """The loss and every gradient on the card against the CPU within 3e-5,
    every layer rematerialized; training launches no flash kernel."""
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import flatten_with_path
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype="float32",
                              remat="full", **kw)
    params = get_model(cfg, "cpu").init(0)
    batch = make_batch(cfg, ShapeConfig("t", seq, 2, "train"))
    want_l, want_g = loss_and_grads(get_model(cfg, "cpu").train_loss, params, batch)
    before = ops.COUNTS["flash_attention"].launches
    got_l, got_g = loss_and_grads(get_model(cfg, cuda_device).train_loss,
                                  map_leaves(lambda t: t.to(cuda_device), params), batch)
    assert ops.COUNTS["flash_attention"].launches == before
    np.testing.assert_allclose(got_l.item(), want_l.item(), rtol=3e-5, atol=3e-5)
    for (p, a), (_q, b) in zip(flatten_with_path(got_g), flatten_with_path(want_g)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=3e-5, atol=3e-5,
                                   err_msg=p)


@pytest.mark.parametrize("arch,kw,seq,flash_calls", FAMILIES[1:])
def test_family_bf16_prefill_takes_the_tensor_core_route(cuda_device, arch, kw, seq,
                                                         flash_calls):
    """bf16: every flash launch of a zamba2, whisper or hybrid_moe prefill is on the
    wgmma route, and whisper's encoder launches at its 32 frames."""
    cfg = dataclasses.replace(get_config(arch).scaled_down(), **kw)
    model = get_model(cfg, cuda_device)
    batch = make_batch(cfg, ShapeConfig("t", seq, 2, "prefill"))
    count = ops.COUNTS["flash_attention"]
    before = dict(count.shapes)
    with torch.inference_mode():
        logits, _ = model.prefill(model.init(0), batch)
    assert bool(torch.isfinite(logits.float()).all())
    new = {k: n - before.get(k, 0) for k, n in count.shapes.items() if n != before.get(k, 0)}
    assert sum(new.values()) == flash_calls
    assert all(k[-1] == "bfloat16" for k in new)
    if cfg.family == "encdec":
        assert new[(2 * cfg.n_heads, cfg.encoder_seq, cfg.head_dim, "bfloat16")] == \
            cfg.encoder_layers


# ------------------------------------------------- the DES on the card
def at_load_report(device):
    from repro_torch.serving import engine
    engine._page_traces.clear()  # each call captures on its own device
    return engine.serve_kv_at_load(900, n_clients=8, n_shards=2, horizon_s=0.002,
                                   share_qp=True, slo_us=250, admission="slo",
                                   collect_trace=True, device=device)


def ycsb_report(device, workload, batch):
    from repro_torch.fabric import SimTransport
    from repro_torch.workloads import run_store_workload
    store = make_store("erda-cluster", n_shards=4, device=device,
                       cfg=ServerConfig(device_size=4 << 20, table_capacity=1 << 10,
                                        n_heads=1, region_size=1 << 20,
                                        segment_size=64 << 10),
                       transport_factory=lambda nvm: SimTransport(nvm))
    return run_store_workload(store, workload, n_ops=300, n_keys=60, value_size=1024,
                              batch_size=batch, contended_threads=4)


def test_serve_kv_at_load_on_card_equals_cpu(cuda_device):
    from repro_torch.serving import event_trace_bytes
    before = ops.COUNTS["crc32_batch"].launches
    card = at_load_report(cuda_device)
    assert ops.COUNTS["crc32_batch"].launches > before
    cpu = at_load_report("cpu")
    assert repr(card) == repr(cpu)
    assert event_trace_bytes(card) == event_trace_bytes(cpu)


@pytest.mark.parametrize("workload,batch", [("ycsb_c", 0), ("ycsb_b", 16)])
def test_store_workload_on_card_equals_cpu(cuda_device, workload, batch):
    before = ops.COUNTS["crc32_batch"].launches
    card = ycsb_report(cuda_device, workload, batch)
    assert ops.COUNTS["crc32_batch"].launches > before
    assert repr(card) == repr(ycsb_report("cpu", workload, batch))
