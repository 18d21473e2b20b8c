"""The port's flash attention (``repro_torch.kernels.ops.flash_attention``;
on the CPU, its plain version) against the JAX package's Pallas kernel in
interpret mode, its plain ``attention_ref``, its ``ops.flash_attention`` and
the model's ``chunked_attention``, on the same inputs made with numpy.
Tolerances are the reference's own (``tests/test_kernels.py``): float32
2e-5, bfloat16 2e-2, the model cross-check 3e-5."""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.layers.attention import chunked_attention as j_chunked
from repro_torch.checkpoint.serialization import to_tensor
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(shape, dtype, seed):
    """q, k, v as numpy arrays of ``dtype`` (bfloat16 via ml_dtypes), so both
    packages start from the same bits."""
    rng = np.random.default_rng(seed)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    return [rng.standard_normal(shape).astype(np.float32).astype(np_dtype)
            for _ in range(3)]


def port_folded(q, k, v, causal):
    """The port's wrapper on (BH, S, hd) arrays, passed as (1, S, BH, hd)."""
    as_bshd = lambda a: to_tensor(a)[None].transpose(1, 2)
    o = ops.flash_attention(as_bshd(q), as_bshd(k), as_bshd(v), causal=causal)
    return o.transpose(1, 2)[0]


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("s,hd,bq,bk", [(128, 64, 64, 64), (256, 128, 128, 128),
                                        (256, 64, 128, 64), (192, 32, 64, 64),
                                        (100, 32, 128, 128), (1, 64, 128, 128),
                                        (160, 256, 64, 64), (65, 256, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_matches_pallas_and_ref(s, hd, bq, bk, dtype):
    q, k, v = inputs((3, s, hd), dtype, seed=s + hd)
    got = port_folded(q, k, v, causal=True)
    assert got.dtype == to_tensor(q).dtype and got.shape == (3, s, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, block_q=bq,
                                    block_k=bk, interpret=True)
    plain = jref.attention_ref(jq, jk, jv, causal=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(got), f32(plain), rtol=tol, atol=tol)


def test_non_causal_matches_pallas():
    q, k, v = inputs((2, 128, 64), "float32", seed=5)
    got = port_folded(q, k, v, causal=False)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=False,
                                  interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_256_matches_pallas(dtype, causal):
    """gemma3's head_dim: the wrapper (the plain version on the CPU) against
    the Pallas kernel in interpret mode at (2, 100, 256), a ragged tail."""
    q, k, v = inputs((2, 100, 256), dtype, seed=256)
    got = port_folded(q, k, v, causal=causal)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=causal,
                                  interpret=True)
    assert 256 in flash.HEAD_DIMS and got.shape == (2, 100, 256)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_version_matches_reference_plain_version():
    q, k, v = inputs((2, 96, 32), "float32", seed=11)
    for causal in (True, False):
        got = ref.attention_ref(*map(to_tensor, (q, k, v)), causal=causal)
        want = jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_wrapper_heads_match_reference_wrapper():
    q, k, v = inputs((2, 128, 4, 64), "float32", seed=6)
    got = ops.flash_attention(*map(to_tensor, (q, k, v)), causal=True)
    assert got.shape == (2, 128, 4, 64)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-5, atol=3e-5)


def test_gqa_with_repeated_kv_matches_model_chunked_attention():
    """H=4 query heads over KV=2 groups: the port repeats each KV head for
    its G=2 query heads (head h reads group h // G), as block_fwd does."""
    cfg = dataclasses.replace(get_config("olmo_1b").scaled_down(),
                              dtype="float32", attn_chunk=64)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 256, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    rep = lambda a: to_tensor(a).repeat_interleave(2, dim=2)
    got = ops.flash_attention(to_tensor(q), rep(k), rep(v), causal=True)
    want = j_chunked(*map(jnp.asarray, (q, k, v)), cfg, causal=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-5, atol=3e-5)


def test_wrapper_rejects_mismatched_shapes_and_other_devices():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 1, 32), q)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.double(), q)
    meta = torch.empty(1, 8, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(meta, meta, meta)


def test_kernel_entry_takes_cuda_tensors_only():
    """The wrapper runs where its tensors lie (it has no device argument):
    the plain version only for CPU tensors; the kernel's entry point refuses
    anything but CUDA tensors instead of computing elsewhere."""
    q = torch.ones(2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_cuda(q, q, q)


def test_cpu_runs_no_kernel():
    before = ops.COUNTS["flash_attention"].launches
    ops.flash_attention(*[torch.ones(1, 4, 2, 32)] * 3)
    assert ops.COUNTS["flash_attention"].launches == before


def wgmma_model(q, k, v, causal):
    """A torch model of the bf16 kernel's numerics (csrc/flash_attention.cu,
    flash_fwd_wgmma_kernel): 64-row query tiles over 64-key tiles, causal
    tiles in the future skipped, S = Q K^T accumulated in f32 and scaled in
    f32 by log2(e)/sqrt(hd), NEG_INF masking on the diagonal tile, exp2
    online softmax, P rounded to bf16 before P V, l clamped at 1e-30.
    q, k, v: (BH, S, hd) bf16 -> (BH, S, hd) bf16."""
    bh, s, hd = q.shape
    scale_log2 = torch.tensor((1.0 / np.sqrt(hd)) * np.log2(np.e), dtype=torch.float32)
    out = torch.empty(bh, s, hd, dtype=torch.float32)
    rows_all = torch.arange(s)
    for q0 in range(0, s, 64):
        rows = rows_all[q0:q0 + 64]
        qt = q[:, rows].float()
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        acc = torch.zeros(bh, len(rows), hd)
        n_tiles = (rows[-1].item() // 64 + 1) if causal else -(-s // 64)
        for t in range(n_tiles):
            keys = rows_all[t * 64:(t + 1) * 64]
            x = torch.einsum("bqh,bkh->bqk", qt, k[:, keys].float()) * scale_log2
            if causal and t == n_tiles - 1:
                x = x.masked_fill(keys[None, None, :] > rows[None, :, None], -1e30)
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkh->bqh", p.bfloat16().float(), v[:, keys].float())
            m = mx
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.bfloat16()


@pytest.mark.parametrize("s,hd", [(128, 64), (256, 128), (256, 64), (192, 32),
                                  (100, 32), (1, 64), (1, 128), (100, 128),
                                  (65, 128), (65, 256), (192, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_numerics_model_within_bf16_tolerance(s, hd, causal):
    """The bf16 kernel's arithmetic, modelled on the CPU, against the JAX
    package's plain version and its Pallas kernel in interpret mode; the
    model's error is the prediction for the card's."""
    q, k, v = inputs((3, s, hd), "bfloat16", seed=s + hd)
    got = wgmma_model(*map(to_tensor, (q, k, v)), causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    plain = jref.attention_ref(jq, jk, jv, causal=causal)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, interpret=True)
    np.testing.assert_allclose(f32(got), f32(plain), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(got), f32(pallas), rtol=2e-2, atol=2e-2)
    # and the port's own plain version on the same bits
    want = ref.attention_ref(*map(to_tensor, (q, k, v)), causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_launch_keys_name_the_route():
    shapes = {(64, 256, 128, "bfloat16"): 32, (3, 192, 32, "float32"): 2,
              (2, 8, 64, "bfloat16"): 1}
    assert flash.launches_by_route(shapes) == {"wgmma": 33, "cuda_core": 2}
    assert flash.dtype_name(torch.bfloat16) == "bfloat16"
