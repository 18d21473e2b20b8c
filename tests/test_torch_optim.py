"""The port's optimizer (``repro_torch.optim``) against the JAX package's
on the same inputs: AdamW steps on float32 and bfloat16 parameters with the
clip engaged (1e-6), the cosine schedule, and int8 compression with error
feedback (exact); then the reference's own optimizer tests
(``tests/test_optim.py``) run on the port."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jschedule
from repro_torch.checkpoint.serialization import tree_from_numpy, tree_to_numpy
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, compress_int8,
                               cosine_schedule, decompress_int8)
from repro_torch.optim.adamw import global_norm
from repro_torch.optim.compression import compress_tree, ef_compress
from repro_torch.tree import flatten_with_path

TOL = dict(rtol=1e-6, atol=1e-6)


def tree_np(dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"layers": {"w": (rng.standard_normal((3, 8, 16)) * scale).astype(dtype)},
            "embed": {"table": (rng.standard_normal((32, 8)) * scale).astype(dtype)},
            "bias": (rng.standard_normal((5,)) * scale).astype(dtype)}


def assert_tree_close(got, want, **tol):
    gl, wl = flatten_with_path(tree_to_numpy(got)), flatten_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (p, g), (_q, w) in zip(gl, wl):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, p
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   err_msg=p, **tol)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_adamw_steps_match_reference(dtype):
    """Three steps on identical gradients, each large enough that the clip
    engages (norm >> 1), with a schedule value as lr_scale."""
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp = jax.tree.map(jnp.asarray, tree_np(dtype, 0))
    tp = tree_from_numpy(tree_np(dtype, 0), "cpu")
    jopt, topt = jadamw.adamw_init(jp), adamw_init(tp)
    for step in range(1, 4):
        grads = tree_np(dtype, step, scale=10.0)
        scale = 0.5 + 0.1 * step
        jp, jopt, jm = jadamw.adamw_update(
            jadamw.AdamWConfig(**cfg), jp, jax.tree.map(jnp.asarray, grads), jopt,
            jnp.float32(scale))
        tp, topt, tm = adamw_update(AdamWConfig(**cfg), tp,
                                    tree_from_numpy(grads, "cpu"), topt,
                                    torch.tensor(scale, dtype=torch.float32))
        assert float(tm["grad_norm"]) > 10  # the clip engaged
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        assert topt["step"].dtype == torch.int32 and int(topt["step"]) == step
        assert_tree_close(tp, jax.tree.map(np.asarray, jp), **TOL)
        for name in ("m", "v"):
            assert_tree_close(topt[name], jax.tree.map(np.asarray, jopt[name]), **TOL)


def test_global_norm_matches_reference():
    grads = tree_np(np.float32, 4)
    np.testing.assert_allclose(float(global_norm(tree_from_numpy(grads, "cpu"))),
                               float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads))),
                               rtol=1e-6)


def test_cosine_schedule_matches_reference():
    kw = dict(warmup=20, total=100)
    got = [float(cosine_schedule(s, **kw)) for s in range(121)]
    want = [float(jschedule.cosine_schedule(s, **kw)) for s in range(121)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a 0-d int32 step tensor (the optimizer's) gives the same float32 value
    t = cosine_schedule(torch.tensor(37, dtype=torch.int32), **kw)
    assert t.dtype == torch.float32 and t.dim() == 0 and float(t) == got[37]


def test_int8_compression_is_exact_against_reference():
    rng = np.random.default_rng(5)
    # halves land on .5 steps: both packages round them to even
    g = np.concatenate([rng.standard_normal(997).astype(np.float32),
                        np.float32([127.0, -63.5, 0.5, -0.5, 1.5, 2.5])])
    q, scale = compress_int8(torch.from_numpy(g))
    jq, jscale = jcomp.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(decompress_int8(q, scale).numpy(),
                                  np.asarray(jcomp.decompress_int8(jq, jscale)))
    tree = tree_np(np.float32, 6)
    got = compress_tree(tree_from_numpy(tree, "cpu"))
    want = jcomp.compress_tree(jax.tree.map(jnp.asarray, tree))
    pairs = list(zip(_pairs(got), _pairs(want)))
    assert len(pairs) == 3
    for (p, (tq, ts)), (_q, (jq, js)) in pairs:
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq), err_msg=p)
        assert float(ts) == float(js), p


def _pairs(tree, prefix=""):
    """(path, (q, scale)) of a compressed tree in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def test_error_feedback_is_exact_against_reference():
    rng = np.random.default_rng(1)
    err, jerr = torch.zeros(64), jnp.zeros(64)
    for _ in range(20):
        g = (rng.standard_normal(64) * 0.01).astype(np.float32)
        q, scale, err = ef_compress(torch.from_numpy(g), err)
        jq, jscale, jerr = jcomp.ef_compress(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


# ------------------------------------------ tests/test_optim.py on the port
def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(cfg, params, grads, opt)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_caps_global_norm():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    new, _, metrics = adamw_update(cfg, params, {"w": torch.full((4,), 1e6)}, opt)
    assert metrics["grad_norm"] > 1e5  # reported pre-clip
    assert torch.isfinite(new["w"]).all()


def test_schedule_warmup_and_decay():
    assert float(cosine_schedule(0, warmup=10, total=100)) == 0.0
    assert float(cosine_schedule(10, warmup=10, total=100)) == pytest.approx(1.0)
    assert float(cosine_schedule(100, warmup=10, total=100)) == pytest.approx(0.1)
    assert float(cosine_schedule(55, warmup=10, total=100)) < 1.0


def test_int8_compression_roundtrip_error():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, scale = compress_int8(g)
    assert q.dtype == torch.int8
    err = float((decompress_int8(q, scale) - g).abs().max())
    assert err <= float(scale) + 1e-7  # quantization bound: half-step <= scale


def test_error_feedback_converges():
    """With EF, the accumulated compressed sum tracks the true sum."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64)
    comp_sum = np.zeros(64)
    err = torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy((rng.standard_normal(64) * 0.01).astype(np.float32))
        true_sum += g.numpy()
        q, scale, err = ef_compress(g, err)
        comp_sum += decompress_int8(q, scale).numpy()
    resid = np.abs(true_sum - comp_sum).max()
    assert resid <= float(err.abs().max()) + 1e-6  # bounded by the residual


def test_adamw_keeps_param_dtype_and_device_of_step():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    opt = adamw_init(params)
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0
    assert all(t.dtype == torch.float32 for _p, t in flatten_with_path(opt["m"]))
    new, opt, _ = adamw_update(AdamWConfig(), params,
                               {"a": torch.ones(3, dtype=torch.bfloat16),
                                "b": torch.ones(2)}, opt)
    assert new["a"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32
    assert int(opt["step"]) == 1
