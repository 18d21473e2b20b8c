"""The port's whisper-style encoder-decoder (``repro_torch.models.encdec``)
and its two shared helpers (``sinusoidal_positions``, ``qkv`` with
``kv_x`` and without positions) against the JAX package's, on the CPU in
float32: the model's prefill, decode and ``train_loss`` with every gradient
(3e-5); the decoder positions' clamp at and past ``max_seq``; decode
against prefill; greedy tokens through both engines, with the stub
frontend's frames; and a preempted decode against a clean one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as JE
from repro.models.layers import attention as JA
from repro.models.layers import basic as JB
from repro_torch.models import encdec as TE
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import basic as TB
from torch_family_parity import (check_prefill_and_decode, check_train_loss, close,
                                 configs, decode_matches_prefill,
                                 engine_tokens_equal_reference,
                                 init_cache_matches_reference, preempted_equals_clean,
                                 setup)

ARCH = "whisper_small"
#: narrower widths for the tests whose restores run the plain CRC version
TINY = dict(n_layers=2, encoder_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=64)


@pytest.mark.parametrize("seq,d", [(32, 128), (7, 10), (64, 768)])
def test_sinusoidal_positions_match_reference(seq, d):
    got = TB.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    close(got, JB.sinusoidal_positions(seq, d))


def test_sinusoidal_positions_at_whisper_width_within_an_angle_spacing():
    """1500 frames at d 768: float32 angles near 1500 rad lie 2^-13 apart,
    and one of the 384 denominators 10000^(2i/768) differs in its last
    place between XLA's ``pow`` and the port's, so that column's angles
    differ by up to one spacing and its sin / cos by as much (3.05e-5);
    every other column agrees within 3e-5."""
    got = TB.sinusoidal_positions(1500, 768).numpy()
    want = np.asarray(JB.sinusoidal_positions(1500, 768))
    err = np.abs(got - want)
    assert err.max() <= np.spacing(np.float32(1500.0))
    bad_cols = {c % 384 for c in np.nonzero(err > 3e-5)[1]}
    assert len(bad_cols) <= 1


def test_sinusoidal_positions_are_made_once_per_device():
    a = TB.sinusoidal_positions(32, 128, torch.device("cpu"))
    assert TB.sinusoidal_positions(32, 128, torch.device("cpu")) is a
    assert not a.is_inference()


def test_qkv_with_kv_x_and_without_positions_matches_reference():
    """Cross-attention: queries from x, keys and values from ``kv_x`` (of
    another length), unrotated; whisper's rope_theta is 0, so positions
    rotate nothing either."""
    jcfg, tcfg = configs(ARCH)
    rope = dataclasses.replace(jcfg, rope_theta=10_000.0)
    jp = JA.init_attention(jcfg, jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.arange(5)
    cases = [(jcfg, tcfg, None, None), (jcfg, tcfg, pos, None),
             (jcfg, tcfg, None, enc), (rope, dataclasses.replace(tcfg, rope_theta=1e4), pos, enc),
             (rope, dataclasses.replace(tcfg, rope_theta=1e4), pos, None)]
    for jc, tc, p, kv in cases:
        jq, jk, jv = JA.qkv(jp, jnp.asarray(x), jc, None if p is None else jnp.asarray(p),
                            kv_x=None if kv is None else jnp.asarray(kv))
        tq, tk, tv = TA.qkv(tp, torch.from_numpy(x), tc,
                            None if p is None else torch.from_numpy(p),
                            kv_x=None if kv is None else torch.from_numpy(kv))
        assert tuple(tk.shape) == jk.shape == (2, 5 if kv is None else 11, 4, 32)
        for a, b in ((tq, jq), (tk, jk), (tv, jv)):
            close(a, b)


def test_no_frequencies_are_built_for_theta_0(monkeypatch):
    _j, tcfg = configs(ARCH)
    monkeypatch.setattr(TB, "rope_frequencies", None)  # a call would raise
    p = {k: torch.ones(tcfg.d_model, tcfg.q_dim) for k in ("wq", "wk", "wv")}
    q, _k, _v = TA.qkv(p, torch.ones(1, 3, tcfg.d_model), tcfg, torch.arange(3))
    assert torch.equal(q, torch.full_like(q, float(tcfg.d_model)))


def test_encode_matches_reference():
    jcfg, _jm, jparams, _tm, tparams = setup(ARCH)
    frames = np.random.default_rng(3).standard_normal(
        (2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, f: JE.encode(jcfg, p, f))(jparams, jnp.asarray(frames))
    with torch.inference_mode():
        got = TE.encode(_tm.cfg, tparams, frames)
    close(got, want)


@pytest.mark.parametrize("seq", [16, 24])
def test_prefill_and_decode_match_reference(seq):
    cache = check_prefill_and_decode(ARCH, seq=seq)
    assert tuple(cache["cross"]["k"].shape) == (4, 2, 32, 4, 32)
    assert tuple(cache["self"]["k"].shape) == (4, 2, seq + 128, 4, 32)


def test_train_loss_and_grads_match_reference():
    check_train_loss(ARCH, seq=24)


def test_train_loss_with_remat_matches_reference():
    check_train_loss(ARCH, seq=16, remat="full", **TINY)


@pytest.mark.parametrize("start", [0, 5, 37, 38, 40, 100])
def test_dec_pos_clamps_as_dynamic_slice(start):
    """``dynamic_slice_in_dim`` clamps a start past ``max_seq - size`` (the
    reference's max_seq 40): decode at pos >= max_seq reads the last row."""
    jcfg, _jm, jparams, _tm, tparams = setup(ARCH, max_seq=40)
    for size in (1, 3):
        want = jax.lax.dynamic_slice_in_dim(jparams["dec_pos"], start, size, axis=0)
        got = TE._dec_pos(tparams, torch.tensor(start, dtype=torch.int32), size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(TE._dec_pos(tparams, start, size).numpy(),
                                      np.asarray(want))


def test_decode_past_max_seq_matches_reference():
    """A decode cache at pos 39 and 40 of max_seq 40: both packages read
    ``dec_pos``'s last row."""
    jcfg, jm, jparams, tm, tparams = setup(ARCH, max_seq=40, **TINY)
    tok = np.array([[3], [7]], np.int32)
    jc, tc = jm.init_cache(2, 38), tm.init_cache(2, 38)
    for _ in range(3):
        jl, jc = jax.jit(jm.decode_step)(jparams, jc, jnp.asarray(tok))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok))
        close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 41


def test_decode_matches_prefill():
    assert decode_matches_prefill(ARCH) < 1e-4


def test_engine_tokens_equal_reference():
    """The stub frontend's frames ride in the batch through both engines."""
    engine_tokens_equal_reference(ARCH, **TINY)


def test_preempted_decode_equals_clean():
    _j, tcfg = configs(ARCH, **TINY)
    preempted_equals_clean(tcfg)


def test_frames_reach_prefill_through_the_engine_unchanged():
    from repro_torch.models import get_model
    from repro_torch.serving import ServeEngine
    _j, tcfg = configs(ARCH, **TINY)
    model = get_model(tcfg, "cpu")
    seen = []

    def prefill(params, batch):
        seen.append(batch)
        return model.prefill(params, batch)
    batch = {"tokens": np.ones((1, 4), np.int32),
             "frames": np.random.default_rng(0).standard_normal(
                 (1, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)}
    engine = ServeEngine(model, model.init(0), device="cpu")
    engine._prefill = prefill
    engine.generate(batch, 2)
    assert seen[0]["frames"] is batch["frames"]


def test_init_cache_matches_reference_tree():
    init_cache_matches_reference(ARCH)
