"""The port's rwkv6 (ssm family: ``repro_torch.models.layers.rwkv`` and
``models.rwkv_model``) against the JAX package's, on the CPU in float32
unless a case says bf16: ``wkv_chunked`` at prompt lengths that do and do
not divide the chunk, with and without a carried state; the time and
channel mixes; the model's prefill, decode and ``train_loss`` with every
gradient (3e-5); decode against prefill; greedy tokens through both
engines; and a preempted decode against a clean one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import rwkv as JR
from repro_torch.models.layers import rwkv as TR
from torch_family_parity import (check_prefill_and_decode, check_train_loss, close,
                                 configs, decode_matches_prefill,
                                 engine_tokens_equal_reference,
                                 init_cache_matches_reference, preempted_equals_clean)

H, HD = 2, 8


def wkv_inputs(S, seed, carried):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((2, S, H, HD)).astype(np.float32) for _ in range(3))
    # decays in (0, 1), from near 0 to near 1, as exp(-exp(w0 + lora)) gives
    w = np.exp(-np.exp(rng.uniform(-6.0, 1.0, (2, S, H, HD)))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, HD))).astype(np.float32)
    h0 = (rng.standard_normal((2, H, HD, HD)) if carried
          else np.zeros((2, H, HD, HD))).astype(np.float32)
    return r, k, v, w, u, h0


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 32, 48, 64])
def test_wkv_chunked_matches_reference(S, carried):
    """Chunk 16: S = 48 takes chunks of 16, and S = 1 (decode) one chunk
    of 1; a carried state enters every chunk's output."""
    args = wkv_inputs(S, seed=S, carried=carried)
    jy, jh = JR.wkv_chunked(*map(jnp.asarray, args), chunk=16)
    ty, th = TR.wkv_chunked(*map(torch.from_numpy, args), chunk=16)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    close(ty, jy)
    close(th, jh)


def test_wkv_chunk_choice_is_the_references():
    """48 tokens at chunk 32 halve to 16; 1500 at 64 to 4."""
    from repro_torch.models.layers.basic import halved_chunk
    assert [halved_chunk(32, 48), halved_chunk(64, 1500), halved_chunk(64, 1),
            halved_chunk(16, 64)] == [16, 4, 1, 16]
    args = wkv_inputs(48, seed=1, carried=True)
    jy, _ = JR.wkv_chunked(*map(jnp.asarray, args), chunk=32)
    ty, _ = TR.wkv_chunked(*map(torch.from_numpy, args), chunk=32)
    close(ty, jy)


def block_params(dtype="float32"):
    jcfg, tcfg = configs("rwkv6_1p6b", dtype=dtype)
    jp = JR.init_rwkv_block(jcfg, jax.random.PRNGKey(3))
    from repro_torch.checkpoint.serialization import to_tensor
    from repro_torch.tree import map_leaves
    tp = map_leaves(lambda a: to_tensor(np.asarray(a)), jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def mix_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    H_, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    state = {"shift": rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32),
             "h": rng.standard_normal((2, H_, hd, hd)).astype(np.float32)}
    return x, state


@pytest.mark.parametrize("with_state", [False, True])
def test_time_and_channel_mix_match_reference(with_state):
    jcfg, tcfg, jp, tp = block_params()
    x, state = mix_inputs(jcfg, 24, seed=5)
    jst = {k: jnp.asarray(v) for k, v in state.items()} if with_state else None
    tst = {k: torch.from_numpy(v) for k, v in state.items()} if with_state else None
    jy, jnew = JR.apply_time_mix(jp["tm"], jnp.asarray(x), jcfg, jst)
    ty, tnew = TR.apply_time_mix(tp["tm"], torch.from_numpy(x), tcfg, tst)
    close(ty, jy)
    close(tnew["h"], jnew["h"])
    close(tnew["shift"], jnew["shift"])
    cst = None if not with_state else {"shift": state["shift"]}
    jy, jnew = JR.apply_channel_mix(jp["cm"], jnp.asarray(x), jcfg,
                                    None if cst is None else {"shift": jnp.asarray(cst["shift"])})
    ty, tnew = TR.apply_channel_mix(tp["cm"], torch.from_numpy(x), tcfg,
                                    None if cst is None else {"shift": torch.from_numpy(cst["shift"])})
    close(ty, jy)
    close(tnew["shift"], jnew["shift"])


def test_time_mix_bf16_within_the_bf16_bound():
    """bf16 weights and activations: XLA's CPU backend fuses bf16 chains in
    float32, so the packages agree to the bf16 bound only."""
    jcfg, tcfg, jp, tp = block_params("bfloat16")
    x, _ = mix_inputs(jcfg, 32, seed=6)
    jy, jnew = JR.apply_time_mix(jp["tm"], jnp.asarray(x, jnp.bfloat16), jcfg)
    ty, tnew = TR.apply_time_mix(tp["tm"], torch.from_numpy(x).bfloat16(), tcfg)
    assert ty.dtype == torch.bfloat16 and tnew["h"].dtype == torch.float32
    close(ty, jy, dict(rtol=2e-2, atol=2e-2))
    close(tnew["h"], jnew["h"], dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("seq", [32, 48])
def test_prefill_and_decode_match_reference(seq):
    cache = check_prefill_and_decode("rwkv6_1p6b", seq=seq)
    # the reference's tree: per-layer (shift, state) stacked over layers
    assert tuple(cache["layers"]["tm"]["h"].shape) == (4, 2, 4, 32, 32)


def test_train_loss_and_grads_match_reference():
    """40 tokens: the WKV chunk halves from 16 to 8."""
    check_train_loss("rwkv6_1p6b", seq=40)


def test_remat_gives_the_same_gradients():
    """Each layer rematerialized (``remat="full"``) recomputes the same
    arithmetic: loss and gradients equal the kept-activation run's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.models import get_model
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import flatten_with_path
    runs = []
    for remat in ("none", "full"):
        _j, tcfg = configs("rwkv6_1p6b", remat=remat, n_layers=2)
        model = get_model(tcfg, "cpu")
        batch = make_batch(tcfg, ShapeConfig("t", 24, 2, "train"))
        runs.append(loss_and_grads(model.train_loss, model.init(0), batch))
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb)
    for (p, a), (_q, b) in zip(flatten_with_path(ga), flatten_with_path(gb)):
        assert torch.equal(a, b), p


def test_decode_matches_prefill():
    assert decode_matches_prefill("rwkv6_1p6b") < 1e-4


def test_engine_tokens_equal_reference():
    engine_tokens_equal_reference("rwkv6_1p6b", n_layers=2)


def test_preempted_decode_equals_clean():
    """The analogue of the reference's rwkv6 case of
    ``tests/test_serving.py::test_preemption_recovery_bit_identical``."""
    _j, tcfg = configs("rwkv6_1p6b")
    preempted_equals_clean(tcfg)


def test_init_cache_matches_reference_tree():
    init_cache_matches_reference("rwkv6_1p6b")
