"""Shared checks for the family parity tests (``test_torch_rwkv.py``,
``test_torch_hybrid.py``, ``test_torch_encdec.py``): a family's port
against the JAX package on the same weights (``params_from_numpy``) and
prompts, in float32 on the CPU — prefill logits and every cache leaf,
decode steps, ``train_loss`` and every gradient within 3e-5 (the
reference's model cross-check), decode against prefill within the
reference's smoke bound, and greedy tokens through both serving engines."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.data import make_batch
from repro.models import get_model as j_get_model
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy, to_reference_tree
from repro_torch.serving import ServeEngine
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import flatten_with_path

TOL = dict(rtol=3e-5, atol=3e-5)
CPU = torch.device("cpu")


def configs(arch, **kw):
    kw = dict(dict(dtype="float32"), **kw)
    return (dataclasses.replace(j_get_config(arch).scaled_down(), **kw),
            dataclasses.replace(get_config(arch).scaled_down(), **kw))


def setup(arch, max_seq=96, **kw):
    """(jcfg, JAX model, JAX params, port model, port params from them)."""
    jcfg, tcfg = configs(arch, **kw)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=max_seq)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    return jcfg, jmodel, jparams, get_model(tcfg, CPU), tparams


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np_(got), np_(want), err_msg=msg, **tol)


def assert_tree_close(ttree, jtree, tol=TOL):
    """Same leaf paths, shapes, dtypes and values (within ``tol``)."""
    tl = flatten_with_path(ttree)
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    for (path, t), (_p, j) in zip(tl, jl):
        assert tuple(t.shape) == j.shape, path
        assert t.dtype == getattr(torch, str(j.dtype)), path
        close(t, j, tol, path)


def prompts(jcfg, seq, batch=2):
    return make_batch(jcfg, ShapeConfig("t", seq, batch, "prefill"))


def check_prefill_and_decode(arch, seq=32, steps=3, **kw):
    """Prefill logits and cache, then ``steps`` greedy decode steps' logits
    and caches, the port against the reference."""
    jcfg, jm, jparams, tm, tparams = setup(arch, **kw)
    batch = prompts(jcfg, seq)
    jl, jc = jax.jit(jm.prefill)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, batch)
    close(tl, jl)
    assert_tree_close(tc, jc)
    jdec = jax.jit(jm.decode_step)
    for _ in range(steps):
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jdec(jparams, jc, jtok)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, tc, ttok)
        close(tl, jl)
        assert_tree_close(tc, jc)
    assert int(tc["pos"]) == int(jc["pos"]) == seq + steps
    return tc


def check_train_loss(arch, seq=32, **kw):
    """``train_loss`` and every gradient leaf, in the reference's paths."""
    jcfg, jm, jparams, tm, tparams = setup(arch, **kw)
    batch = make_batch(jcfg, ShapeConfig("t", seq, 2, "train"))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = loss_and_grads(tm.train_loss, tparams, batch)
    close(tloss, jloss)
    assert_tree_close(to_reference_tree(tgrads), jgrads)


def decode_matches_prefill(arch, S=16, **kw):
    """Teacher forcing: decoding token S with prefill(0..S-1)'s cache gives
    prefill(0..S)'s logits (the reference's ``test_decode_matches_prefill``,
    its 2e-2 bound, here in float32 on the port alone)."""
    _j, tcfg = configs(arch, **kw)
    model = get_model(tcfg, CPU)
    params = model.init(0, max_seq=40)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                             size=(2, S + 1)).astype(np.int32)
    extra = {k: v for k, v in prompts(tcfg, S).items() if k != "tokens"}
    with torch.inference_mode():
        _la, cache = model.prefill(params, dict(extra, tokens=toks[:, :S]))
        step, _ = model.decode_step(params, cache, torch.from_numpy(toks[:, S:S + 1]))
        want, _ = model.prefill(params, dict(extra, tokens=toks))
    np.testing.assert_allclose(step.numpy(), want.numpy(), rtol=2e-2, atol=2e-2)
    return float((step - want).abs().max())


def engine_tokens_equal_reference(arch, seq=16, tokens=8, crash_at=4, **kw):
    """Greedy tokens through the reference's engine and the port's, each
    preempted at ``crash_at`` and restored from its page store."""
    jcfg, jm, jparams, tm, tparams = setup(arch, **kw)
    batch = prompts(jcfg, seq)
    want = JEngine(jm, jparams, snapshot_every=2).generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, tokens, crash_at=crash_at)
    got = ServeEngine(tm, tparams, snapshot_every=2, device=CPU).generate(
        batch, tokens, crash_at=crash_at)
    np.testing.assert_array_equal(got, np.asarray(want))
    return got


def preempted_equals_clean(cfg, seq=16, tokens=8, crash_at=4):
    """Through the port's ``ServeEngine`` and page store: a decode preempted
    at ``crash_at`` equals a clean one; returns the engine that recovered."""
    model = get_model(cfg, CPU)
    params = model.init(0)
    batch = prompts(cfg, seq)
    clean = ServeEngine(model, params, snapshot_every=2, device=CPU).generate(
        batch, tokens, seq_id=1)
    engine = ServeEngine(model, params, snapshot_every=2, device=CPU)
    crashy = engine.generate(batch, tokens, seq_id=2, crash_at=crash_at)
    assert clean.shape == (2, tokens)
    np.testing.assert_array_equal(clean, crashy)
    assert engine.pages.stats["reads"] > 0
    return engine


def init_cache_matches_reference(arch, batch=3, seq=40, **kw):
    """``init_cache``'s tree: the reference's paths, shapes, dtypes and
    values."""
    jcfg, tcfg = configs(arch, **kw)
    jc = j_get_model(jcfg).init_cache(batch, seq)
    tc = get_model(tcfg, CPU).init_cache(batch, seq)
    tl = flatten_with_path(tc)
    jl = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert [p for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    for (path, t), (_p, j) in zip(tl, jl):
        assert tuple(t.shape) == j.shape and t.dtype == getattr(torch, str(j.dtype)), path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return tc
