"""The port's Mamba2 layer and zamba2 hybrid (``repro_torch.models.layers.
ssm`` and ``models.hybrid``) against the JAX package's, on the CPU in
float32 unless a case says bf16: the causal conv with and without a carried
state, the segment-sum decay, the chunked SSD and the decode recurrence,
softplus; the model's prefill, decode and ``train_loss`` with every
gradient (3e-5), on the scaled-down config (6 groups of 2, no tail) and on
one with a tail (5 layers at every 2); decode against prefill; greedy
tokens through both engines; and a preempted decode against a clean one,
whose cache has no tail."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import ssm as JS
from repro_torch.models.layers import ssm as TS
from torch_family_parity import (check_prefill_and_decode, check_train_loss, close,
                                 configs, decode_matches_prefill,
                                 engine_tokens_equal_reference,
                                 init_cache_matches_reference, preempted_equals_clean)

#: scaled-down configs with a tail (2 groups of 2 ssm layers, then 1) and
#: without one (2 groups of 2), as zamba2's scaled-down 12 layers at every 2
TAIL = dict(n_layers=5, shared_attn_every=2)
NO_TAIL = dict(n_layers=4, shared_attn_every=2)
ARCH = "zamba2_1p2b"
#: narrower widths for the tests whose restores run the plain CRC version, a
#: loop over every byte of a record
TINY = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=64, ssm_head_dim=16, ssm_state=8)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 7])
def test_causal_conv_matches_reference(S, carried):
    rng = np.random.default_rng(S)
    xBC, w = rand(rng, 2, S, 24), 0.5 * rand(rng, 4, 24)
    state = rand(rng, 2, 3, 24) if carried else None
    jy, jst = JS._causal_conv(jnp.asarray(xBC), jnp.asarray(w),
                              None if state is None else jnp.asarray(state))
    ty, tst = TS._causal_conv(torch.from_numpy(xBC), torch.from_numpy(w),
                              None if state is None else torch.from_numpy(state))
    close(ty, jy)
    close(tst, jst)


def test_causal_conv_bf16_within_the_bf16_bound():
    """XLA's CPU backend sums the bf16 taps in float32; torch rounds each
    partial sum: the bf16 bound only."""
    rng = np.random.default_rng(0)
    xBC, w = rand(rng, 2, 16, 24), 0.5 * rand(rng, 4, 24)
    jy, _ = JS._causal_conv(jnp.asarray(xBC, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    ty, _ = TS._causal_conv(torch.from_numpy(xBC).bfloat16(), torch.from_numpy(w).bfloat16())
    assert ty.dtype == torch.bfloat16
    close(ty, jy, dict(rtol=2e-2, atol=2e-2))


def test_segsum_decay_matches_reference():
    dA = -np.abs(rand(np.random.default_rng(1), 2, 16, 3))
    jL, jcum = JS._segsum_decay(jnp.asarray(dA))
    tL, tcum = TS._segsum_decay(torch.from_numpy(dA))
    close(tL, jL)
    close(tcum, jcum)
    assert float(tL[0, 0, 1, 0]) == 0.0  # masked above the diagonal


def test_softplus_is_jaxs():
    """``logaddexp(x, 0)`` on both sides of torch's threshold of 20."""
    x = np.linspace(-60.0, 60.0, 4001).astype(np.float32)
    close(TS.softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)))


def ssd_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    nh, hp, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = rand(rng, 2, S, nh, hp)
    B_in, C_in = rand(rng, 2, S, ds), rand(rng, 2, S, ds)
    dt = np.log1p(np.exp(rand(rng, 2, S, nh))).astype(np.float32)
    A = -np.exp(0.3 * rand(rng, nh))
    h0 = rand(rng, 2, nh, hp, ds)
    return x, B_in, C_in, dt, A, h0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [16, 24, 48])
def test_ssm_chunked_matches_reference(S, with_state):
    """Chunk 16: S = 24 halves it to 8."""
    jcfg, tcfg = configs(ARCH)
    x, B_in, C_in, dt, A, h0 = ssd_inputs(jcfg, S, seed=S)
    h0 = h0 if with_state else None
    jy, jh = JS.ssm_chunked(jcfg, *map(jnp.asarray, (x, B_in, C_in, dt, A)),
                            h0=None if h0 is None else jnp.asarray(h0))
    ty, th = TS.ssm_chunked(tcfg, *map(torch.from_numpy, (x, B_in, C_in, dt, A)),
                            h0=None if h0 is None else torch.from_numpy(h0))
    close(ty, jy)
    close(th, jh)


def layer_params(cfg_pair, seed=2):
    from repro_torch.checkpoint.serialization import to_tensor
    from repro_torch.tree import map_leaves
    jcfg, _t = cfg_pair
    jp = JS.init_ssm(jcfg, jax.random.PRNGKey(seed))
    # a nonzero A_log and dt_bias, so that neither is left untested at 0
    rng = np.random.default_rng(seed)
    jp = dict(jp, A_log=jnp.asarray(0.3 * rand(rng, jcfg.ssm_heads)),
              dt_bias=jnp.asarray(0.5 * rand(rng, jcfg.ssm_heads)))
    return jp, map_leaves(lambda a: to_tensor(np.array(a)), jax.tree.map(np.asarray, jp))


def test_apply_ssm_then_decode_ssm_match_reference():
    """The mixer over a prompt, then three decode steps from its state."""
    pair = configs(ARCH)
    jcfg, tcfg = pair
    jp, tp = layer_params(pair)
    rng = np.random.default_rng(4)
    x = rand(rng, 2, 24, jcfg.d_model)
    jy, jst = JS.apply_ssm(jp, jnp.asarray(x), jcfg)
    ty, tst = TS.apply_ssm(tp, torch.from_numpy(x), tcfg)
    close(ty, jy)
    close(tst["conv"], jst["conv"])
    close(tst["h"], jst["h"])
    for i in range(3):
        xi = rand(rng, 2, 1, jcfg.d_model)
        jy, jst = JS.decode_ssm(jp, jnp.asarray(xi), jcfg, jst)
        ty, tst = TS.decode_ssm(tp, torch.from_numpy(xi), tcfg, tst)
        assert tst["h"].dtype == torch.float32
        close(ty, jy)
        close(tst["conv"], jst["conv"])
        close(tst["h"], jst["h"])


@pytest.mark.parametrize("kw", [NO_TAIL, TAIL], ids=["no_tail", "tail"])
def test_prefill_and_decode_match_reference(kw):
    cache = check_prefill_and_decode(ARCH, seq=24, **kw)
    assert tuple(cache["ssm_main"]["h"].shape[:2]) == (2, 2)
    if kw is TAIL:
        assert tuple(cache["ssm_tail"]["h"].shape[:1]) == (1,)
    else:
        assert cache["ssm_tail"] is None


@pytest.mark.parametrize("kw", [NO_TAIL, TAIL], ids=["no_tail", "tail"])
def test_train_loss_and_grads_match_reference(kw):
    check_train_loss(ARCH, seq=24, **kw)


def test_long_prompt_takes_chunked_attention_and_matches():
    """Above 512 tokens the shared block runs chunked attention on the CPU
    in both packages."""
    check_prefill_and_decode(ARCH, seq=520, steps=1, n_layers=2, attn_chunk=128,
                             ssm_chunk=64)


@pytest.mark.parametrize("kw", [{}, TAIL], ids=["no_tail", "tail"])
def test_decode_matches_prefill(kw):
    assert decode_matches_prefill(ARCH, **kw) < 1e-4


def test_engine_tokens_equal_reference():
    engine_tokens_equal_reference(ARCH, **TAIL, **TINY)


def test_preempted_decode_equals_clean_with_no_tail():
    """No tail, so the snapshot has no page for
    ``ssm_tail`` and the restored cache's tail is None again."""
    from repro_torch.serving.kv_store import _page_key
    _j, tcfg = configs(ARCH, **NO_TAIL, **TINY)
    engine = preempted_equals_clean(tcfg)
    store = engine.pages.store
    assert store.read(_page_key(2, "['ssm_main']['h']", 0)) is not None
    assert store.read(_page_key(2, "['ssm_tail']", 0)) is None


def test_snapshot_and_restore_of_a_cache_without_tail():
    from repro_torch.models import get_model
    from repro_torch.serving import ErdaKVPageStore
    from repro_torch.tree import flatten_with_path
    _j, tcfg = configs(ARCH, **NO_TAIL, **TINY)
    model = get_model(tcfg, "cpu")
    with torch.inference_mode():
        _l, cache = model.prefill(model.init(0), {"tokens": [[3] * 8, [5] * 8]})
    assert cache["ssm_tail"] is None
    store = ErdaKVPageStore(device="cpu")
    assert store.snapshot_cache(1, cache) == len(flatten_with_path(cache)) == 6
    got = store.restore_cache(1, cache)
    assert got["ssm_tail"] is None
    for (p, a), (_q, b) in zip(flatten_with_path(got), flatten_with_path(cache)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("kw", [{}, TAIL], ids=["no_tail", "tail"])
def test_init_cache_matches_reference_tree(kw):
    tc = init_cache_matches_reference(ARCH, **kw)
    assert (tc["ssm_tail"] is None) == (not kw)
