"""The port's sliding-window pieces (``repro_torch.models.layers.attention``
and the ring caches of ``repro_torch.models.transformer``) against the JAX
package's on the same float32 inputs, made with numpy: banded attention and
its gradients, windowed decode attention, ring-buffer cache slots, and the
ring cache a prefill leaves, within the reference's float32 tolerance
(2e-5); caches exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import transformer as JT
from repro.models.layers import attention as JA
from repro_torch.models import transformer as TT
from repro_torch.models.layers import attention as TA

TOL = dict(rtol=2e-5, atol=2e-5)


def cfg(**kw):
    return dataclasses.replace(get_config("mixtral_8x22b").scaled_down(),
                               dtype="float32", **kw)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return rand(rng, B, S, H, hd), rand(rng, B, S, KV, hd), rand(rng, B, S, KV, hd)


# the reference's sweep (tests/test_layers.py), and a prompt that is not a
# multiple of the window
SWEEP = [(128, 32, 32), (256, 64, 64), (128, 64, 32), (96, 64, 64)]


@pytest.mark.parametrize("S,W,chunk", SWEEP)
def test_banded_attention_matches_reference(S, W, chunk):
    c = cfg(attn_chunk=chunk, window=W)
    q, k, v = qkv(S + W, 2, S, 4, 2, 16)  # GQA: 2 query heads a KV head
    want = JA.banded_attention(*map(jnp.asarray, (q, k, v)), c, window=W)
    got = TA.banded_attention(*map(torch.from_numpy, (q, k, v)), c, window=W)
    assert got.shape == (2, S, 4, 16) and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("S,W,chunk", SWEEP[:3])
def test_banded_attention_gradients_match_jax_grad(S, W, chunk):
    c = cfg(attn_chunk=chunk, window=W)
    q, k, v = qkv(7 * S + W, 2, S, 4, 2, 16)
    ct = rand(np.random.default_rng(3), 2, S, 4, 16)
    jgrads = jax.grad(
        lambda a, b, d: jnp.sum(JA.banded_attention(a, b, d, c, window=W) * ct),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TA.banded_attention(*leaves, c, window=W)
    tgrads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for g, j in zip(tgrads, jgrads):
        close(g, j)


def test_banded_equals_masked_dense_within_the_window():
    """A band wider than the prompt is plain causal attention."""
    c = cfg(attn_chunk=32, window=64)
    q, k, v = map(torch.from_numpy, qkv(5, 1, 64, 4, 2, 16))
    close(TA.banded_attention(q, k, v, c, window=64),
          TA.full_attention(q, k, v, causal=True))


@pytest.mark.parametrize("window", [0, 8, 24])
@pytest.mark.parametrize("pos", [5, 19, 30])
def test_windowed_decode_attention_matches_reference(window, pos):
    rng = np.random.default_rng(pos + window)
    q = rand(rng, 2, 1, 4, 16)
    kc, vc = rand(rng, 2, 24, 2, 16), rand(rng, 2, 24, 2, 16)
    kv_pos = np.where(np.arange(24) < 20, np.arange(24) + max(0, pos - 19), -1)
    kv_pos = kv_pos.astype(np.int32)
    want = JA.decode_attention(*map(jnp.asarray, (q, kc, vc, kv_pos)),
                               jnp.int32(pos), window=window)
    got = TA.decode_attention(*map(torch.from_numpy, (q, kc, vc, kv_pos)),
                              torch.tensor(pos, dtype=torch.int32), window=window)
    close(got, want)


@pytest.mark.parametrize("ring", [0, 16])
def test_ring_cache_update_slots_match_reference(ring):
    """Twenty inserts: a ring of 16 slots wraps at position 16 (slot
    pos % 16); without a ring the slot clips to the cache's last."""
    rng = np.random.default_rng(ring)
    jk = jv = jnp.zeros((2, 16, 2, 8), jnp.float32)
    jp = jnp.full((16,), -1, jnp.int32)
    tk, tv, tp = map(lambda a: torch.from_numpy(np.array(a)), (jk, jv, jp))
    for pos in range(20):
        kn, vn = rand(rng, 2, 1, 2, 8), rand(rng, 2, 1, 2, 8)
        jk, jv, jp = JA.cache_update(jk, jv, jp, jnp.asarray(kn), jnp.asarray(vn),
                                     jnp.int32(pos), ring=ring)
        tk, tv, tp = TA.cache_update(tk, tv, tp, torch.from_numpy(kn),
                                     torch.from_numpy(vn),
                                     torch.tensor(pos, dtype=torch.int32), ring=ring)
        for got, want in ((tk, jk), (tv, jv), (tp, jp)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if ring:
        assert tp.tolist() == [16, 17, 18, 19] + list(range(4, 16))


@pytest.mark.parametrize("S,W", [(40, 64), (64, 64), (160, 64), (100, 64), (5, 4)])
def test_ring_cache_from_kv_is_the_reference_cache(S, W):
    """Exact at S < W, S = W and S > W with a shift of W/2 (160), and where
    the reference's rotation leaves slot != pos % W (100, 5: its shift is
    neither 0 nor W/2) — the port keeps the reference's layout there too."""
    rng = np.random.default_rng(S)
    k, v = rand(rng, 2, S, 2, 8), rand(rng, 2, S, 2, 8)
    want = JT._ring_cache_from_kv(jnp.asarray(k), jnp.asarray(v), S, W)
    got = TT._ring_cache_from_kv(torch.from_numpy(k), torch.from_numpy(v), S, W)
    for name in ("k", "v", "kv_pos"):
        assert got[name].dtype == getattr(torch, str(want[name].dtype))
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    # the layer stacks of a prefill: leading axes ride along, positions too
    lead = TT._ring_cache_from_kv(torch.from_numpy(np.stack([k, v])),
                                  torch.from_numpy(np.stack([v, k])), S, W)
    assert lead["kv_pos"].shape == (2, W)
    np.testing.assert_array_equal(lead["k"][0].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(lead["kv_pos"][1].numpy(), np.asarray(want["kv_pos"]))


def test_layer_plan_matches_reference():
    for arch, kw in [("gemma3_27b", {}), ("gemma3_12b", {}), ("olmo_1b", {}),
                     ("mixtral_8x22b", {}), ("gemma3_27b", {"n_layers": 8})]:
        c = dataclasses.replace(get_config(arch), **kw)
        assert TT.layer_plan(c) == JT.layer_plan(c), arch
    plan = TT.layer_plan(get_config("gemma3_27b"))
    assert plan.count("full") == 10 and plan[-2:] == ("window", "window")
