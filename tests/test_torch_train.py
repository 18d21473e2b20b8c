"""The port's training path against the JAX package's, on the CPU: the
losses and their gradients, ``train_loss`` with every gradient leaf on
olmo_1b's scaled-down config in float32 (3e-5, the reference's model
cross-check), the train step with and without microbatches (losses at
rel=1e-4, the reference's bound in ``tests/test_checkpoint.py``), the
trainer's checkpoint → resume, and train-state checkpoints crossing between
the packages in both directions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ErdaCheckpointManager as RMgr
from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.core import ErdaStore as RStore
from repro.core import ServerConfig as RConfig
from repro.core.client import ErdaClient as RClient
from repro.data import make_batch
from repro.models import get_model as j_get_model
from repro.models.layers import basic as JB
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.train import make_train_step as j_make_train_step
from repro.train.step import make_train_state as j_make_train_state
from repro_torch.checkpoint import ErdaCheckpointManager as TMgr
from repro_torch.configs import get_config
from repro_torch.core import ErdaStore as TStore
from repro_torch.core import ServerConfig as TConfig
from repro_torch.core.api import ErdaClusterStore
from repro_torch.core.client import ErdaClient as TClient
from repro_torch.kernels import ops
from repro_torch.launch import train as T
from repro_torch.models import get_model
from repro_torch.models.convert import (from_reference_tree, params_from_numpy,
                                        to_reference_tree, train_state_from_numpy)
from repro_torch.models.layers import basic as TB
from repro_torch.train import make_train_state_abstract, make_train_step
from repro_torch.train.step import loss_and_grads, make_train_state
from repro_torch.tree import flatten_with_path

TOL = dict(rtol=3e-5, atol=3e-5)
CPU = torch.device("cpu")
CFG = dict(device_size=128 << 20, table_capacity=1 << 12, n_heads=2,
           region_size=8 << 20, segment_size=1 << 20)


def configs(**kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(j_get_config("olmo_1b").scaled_down(), **kw),
            dataclasses.replace(get_config("olmo_1b").scaled_down(), **kw))


#: widths for the tests whose restores run the plain CRC version, a loop
#: over every byte of a record
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab_size=64)


def setup(**kw):
    jcfg, tcfg = configs(**kw)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    return jcfg, jmodel, jparams, get_model(tcfg, CPU), tparams


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_grads_close(tgrads, jgrads):
    tl = flatten_with_path(to_reference_tree(tgrads))
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in tl] == [jax.tree_util.keystr(p) for p, _ in jl]
    for (p, t), (_q, j) in zip(tl, jl):
        assert tuple(t.shape) == j.shape, p
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=p, **TOL)


# ---------------------------------------------------------------- losses
def test_cross_entropy_loss_and_grad_match_reference():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    targets = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    jl, jg = jax.value_and_grad(JB.cross_entropy_loss)(jnp.asarray(logits),
                                                       jnp.asarray(targets))
    t = torch.from_numpy(logits).requires_grad_(True)
    tl = TB.cross_entropy_loss(t, torch.from_numpy(targets))
    (tg,) = torch.autograd.grad(tl, t)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("S,chunk,tied", [(48, 32, True),    # chunk halved to 16
                                          (64, 512, False),  # one chunk, untied
                                          (96, 32, True)])   # three chunks
def test_lm_loss_chunked_and_grads_match_reference(S, chunk, tied):
    rng = np.random.default_rng(S)
    d, V = 16, 40
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    tokens = rng.integers(0, V, size=(2, S)).astype(np.int32)
    embed = {"table": rng.standard_normal((V, d)).astype(np.float32) * 0.1}
    if not tied:
        embed["unembed"] = rng.standard_normal((d, V)).astype(np.float32) * 0.1
    jl, (jge, jgx) = jax.value_and_grad(
        lambda e, xx: JB.lm_loss_chunked(e, xx, jnp.asarray(tokens), chunk=chunk),
        argnums=(0, 1))(jax.tree.map(jnp.asarray, embed), jnp.asarray(x))
    te = {k: torch.from_numpy(v).requires_grad_(True) for k, v in embed.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = TB.lm_loss_chunked(te, tx, torch.from_numpy(tokens), chunk=chunk)
    # untied, the table feeds no logit: JAX's gradient for it is zero
    grads = torch.autograd.grad(tl, [tx, *[te[k] for k in sorted(te)]],
                                materialize_grads=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for k, g in zip(sorted(te), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jge[k]), err_msg=k, **TOL)


def test_final_position_carries_no_loss():
    """The final position has no next token: its weight is zero, so its
    hidden state does not move the loss and gets no gradient."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    embed = {"table": torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))}
    tokens = torch.arange(8)[None] % 10
    other = x.clone()
    other[0, -1] += 5.0
    assert float(TB.lm_loss_chunked(embed, x, tokens, chunk=4)) == \
        float(TB.lm_loss_chunked(embed, other, tokens, chunk=4))
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(TB.lm_loss_chunked(embed, x, tokens, chunk=4), x)
    assert float(g[0, -1].abs().sum()) == 0 and float(g[0, :-1].abs().sum()) > 0


# ------------------------------------------------------------ train loss
@pytest.mark.parametrize("remat,S,attn_chunk", [("none", 32, 32), ("full", 32, 32),
                                                ("none", 640, 128), ("full", 640, 128)],
                         ids=["dense", "dense-remat", "chunked", "chunked-remat"])
def test_train_loss_and_every_gradient_match_reference(remat, S, attn_chunk):
    """S = 640 > 512 takes chunked attention in both packages (5 KV chunks,
    each rematerialized); "full" remats every layer, as olmo_1b's full
    config does on the card."""
    kw = dict(remat=remat, attn_chunk=attn_chunk)
    if S > 512:
        kw["n_layers"] = 2
    jcfg, jm, jparams, tm, tparams = setup(**kw)
    batch = make_batch(jcfg, ShapeConfig("t", S, 2, "train"))
    jl, jg = jax.jit(jax.value_and_grad(jm.train_loss))(jparams, jbatch(batch))
    tl, tg = loss_and_grads(tm.train_loss, tparams, batch)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert_grads_close(tg, jg)


def test_remat_gives_the_same_loss_and_gradients():
    _jc, _jm, _jp, tm, tparams = setup()
    _jc2, _jm2, _jp2, tm_remat, _ = setup(remat="full")
    batch = make_batch(tm.cfg, ShapeConfig("t", 32, 2, "train"))
    l0, g0 = loss_and_grads(tm.train_loss, tparams, batch)
    l1, g1 = loss_and_grads(tm_remat.train_loss, tparams, batch)
    assert torch.equal(l0, l1)
    for (p, a), (_q, b) in zip(flatten_with_path(g0), flatten_with_path(g1)):
        assert torch.equal(a, b), p


def test_train_loss_keeps_gradients_of_every_projection():
    _jc, _jm, _jp, tm, tparams = setup()
    batch = make_batch(tm.cfg, ShapeConfig("t", 16, 2, "train"))
    _l, grads = loss_and_grads(tm.train_loss, tparams, batch)
    for layer in grads["layers"]:
        for name in ("wq", "wk", "wv", "wo"):
            assert float(layer["attn"][name].abs().sum()) > 0, name


def test_flash_wrapper_refuses_inputs_that_need_a_gradient():
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 32), torch.randn(1, 8, 2, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=True)
    with torch.inference_mode():
        assert torch.equal(ops.flash_attention(q.detach(), k, v, causal=True), out)
    # no input needs a gradient: allowed with grad mode on
    assert ops.flash_attention(q.detach(), k, v).shape == q.shape


# ------------------------------------------------------------ train step
def j_step_fn(jm, n_micro=1):
    return jax.jit(j_make_train_step(
        jm, JAdamWConfig(lr=3e-3), n_microbatches=n_micro,
        schedule=lambda s: j_cosine_schedule(s, warmup=2, total=10)))


def t_step_fn(tm, n_micro=1):
    from repro_torch.optim import AdamWConfig, cosine_schedule
    return make_train_step(tm, AdamWConfig(lr=3e-3), n_microbatches=n_micro,
                           schedule=lambda s: cosine_schedule(s, warmup=2, total=10))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_losses_match_reference(n_micro):
    jcfg, jm, jparams, tm, tparams = setup(remat="full")
    jstate = {"params": jparams,
              "opt": jax.tree.map(jnp.asarray, j_make_train_state(
                  jm, jax.random.PRNGKey(0))["opt"])}
    tstate = make_train_state(tm)
    tstate["params"] = tparams
    jstep, tstep = j_step_fn(jm, n_micro), t_step_fn(tm, n_micro)
    for s in range(3):
        batch = make_batch(jcfg, ShapeConfig("t", 32, 4, "train"), step=s)
        jstate, jmet = jstep(jstate, jbatch(batch))
        tstate, tmet = tstep(tstate, batch)
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)
        assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    assert int(tstate["opt"]["step"]) == 3


def test_microbatches_average_to_the_full_batch():
    _jc, _jm, _jp, tm, tparams = setup()
    batch = make_batch(tm.cfg, ShapeConfig("t", 16, 4, "train"))
    state = {"params": tparams, "opt": make_train_state(tm)["opt"]}
    _s1, m1 = t_step_fn(tm, 1)(state, batch)
    _s2, m2 = t_step_fn(tm, 2)(state, batch)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-5)


def test_microbatch_split_needs_a_divisible_batch():
    _jc, _jm, _jp, tm, tparams = setup()
    batch = make_batch(tm.cfg, ShapeConfig("t", 16, 3, "train"))
    with pytest.raises(RuntimeError, match="invalid for input"):
        t_step_fn(tm, 2)({"params": tparams, "opt": make_train_state(tm)["opt"]}, batch)


# ----------------------------------------------------- state and templates
def test_abstract_state_is_meta_and_matches_reference_shapes():
    jcfg = j_get_config("olmo_1b").scaled_down()
    model = get_model(get_config("olmo_1b").scaled_down(), CPU)
    abstract = make_train_state_abstract(model)
    leaves = flatten_with_path(to_reference_tree(abstract))
    assert all(t.device.type == "meta" for _p, t in leaves)
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda: j_make_train_state(j_get_model(jcfg), jax.random.PRNGKey(0))))[0]
    assert [p for p, _ in leaves] == [jax.tree_util.keystr(p) for p, _ in want]
    for (p, t), (_q, w) in zip(leaves, want):
        assert tuple(t.shape) == w.shape and str(t.dtype) == f"torch.{w.dtype}", p
    real = make_train_state(model)
    assert T.nbytes(abstract) == T.nbytes(real)


def test_reference_tree_round_trip():
    model = get_model(get_config("olmo_1b").scaled_down(), CPU)
    state = make_train_state(model, 3)
    ref = to_reference_tree(state)
    assert ref["params"]["layers"]["attn"]["wq"].shape[0] == model.cfg.n_layers
    back = from_reference_tree(ref)
    for (p, a), (_q, b) in zip(flatten_with_path(state), flatten_with_path(back)):
        assert torch.equal(a, b), p


def test_train_state_from_numpy_takes_the_reference_state():
    jcfg, tcfg = configs()
    jstate = j_make_train_state(j_get_model(jcfg), jax.random.PRNGKey(1))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, CPU)
    assert len(tstate["params"]["layers"]) == tcfg.n_layers
    assert tstate["opt"]["step"].dtype == torch.int32
    for (p, t), (_q, j) in zip(flatten_with_path(to_reference_tree(tstate)),
                               jax.tree_util.tree_flatten_with_path(jstate)[0]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=p)


# ------------------------------------------------- the trainer and resume
def small_mgr(**kw):
    return TMgr(TStore(TConfig(**CFG), device="cpu"), device="cpu",
                shard_bytes=4096, **kw)


def test_training_restart_resumes():
    """``tests/test_checkpoint.py::test_training_restart_resumes`` on the
    port: train -> checkpoint -> 'kill' -> resume -> identical continuation."""
    mgr = small_mgr()
    _sa, losses_a, _ = T.train(arch="olmo_1b", scale="smoke", steps=6, batch=2,
                               seq=32, ckpt_every=4, ckpt_mgr=mgr, log_every=0,
                               device="cpu")
    _sb, losses_b, _ = T.train(arch="olmo_1b", scale="smoke", steps=6, batch=2,
                               seq=32, ckpt_every=0, resume=True, ckpt_mgr=mgr,
                               log_every=0, device="cpu")
    assert len(losses_b) == 2
    assert losses_b == pytest.approx(losses_a[-2:], rel=1e-4)
    assert losses_b == losses_a[-2:]  # same state, same data, same order


def test_writer_crash_resumes_from_the_previous_checkpoint():
    """The step-4 checkpoint's writer dies after 3 shards (its manifest never
    flips), so the resume starts from step 2 and repeats steps 3-5."""
    mgr = small_mgr()
    _s, losses_a, _ = T.train(steps=5, batch=2, seq=16, ckpt_every=2,
                              fail_ckpt_at=4, ckpt_mgr=mgr, log_every=0,
                              device="cpu")
    _s, losses_b, _ = T.train(steps=5, batch=2, seq=16, resume=True,
                              ckpt_mgr=mgr, log_every=0, device="cpu")
    assert losses_b == losses_a[2:] and len(losses_b) == 3


def tiny_model():
    return get_model(dataclasses.replace(get_config("olmo_1b").scaled_down(), **TINY), CPU)


def test_checkpoint_keys_are_the_reference_paths():
    model = tiny_model()
    mgr = small_mgr()
    T.save_train_state(mgr, 1, make_train_state(model))
    import json
    from repro_torch.checkpoint.erda_ckpt import MANIFEST_KEY
    paths = [e["path"] for e in json.loads(mgr.store.read(MANIFEST_KEY))["entries"]]
    assert "['opt']['m']['layers']['attn']['wq']" in paths
    assert "['opt']['step']" in paths and len(paths) == 3 * 8 + 1  # 8 leaves


def test_checkpoint_manager_is_sized_for_the_state():
    # servers of 1.5 GiB (31-bit log offsets), as many as twice the state
    # takes; their NVM is allocated lazily, so this costs no memory here
    small = T.checkpoint_manager_for(8 << 20, saves=2, device="cpu")
    assert isinstance(small.store, ErdaClusterStore) and len(small.store.devs) == 1
    # olmo_1b's full train state
    full = T.checkpoint_manager_for(11_767_644_160, saves=1, device="cpu")
    assert isinstance(full.store, ErdaClusterStore) and len(full.store.devs) == 15
    assert all(d.size == T.CKPT_SERVER_NVM < 1 << 31 for d in full.store.devs)
    # a train state saved across a 2-server cluster restores bit-exactly
    big = T.checkpoint_manager_for(1 << 30, saves=1, device="cpu")
    assert len(big.store.devs) == 2
    model = tiny_model()
    state = make_train_state(model, 4)
    T.save_train_state(big, 7, state)
    step, got = T.restore_train_state(big, model)
    assert step == 7
    for (p, a), (_q, b) in zip(flatten_with_path(state), flatten_with_path(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


# ------------------------------------------- checkpoints across packages
def port_store_on(server):
    s = object.__new__(TStore)
    s.server, s.dev = server, server.dev
    s.client = TClient(server, device="cpu")
    return s


def ref_store_on(server):
    s = object.__new__(RStore)
    s.server, s.dev = server, server.dev
    s.client = RClient(server)
    return s


def test_port_resumes_a_reference_checkpoint():
    """JAX trains 2 steps and saves with its manager; the port restores
    that train state from the same server and continues as JAX does."""
    jcfg, jm, jparams, tm, _tp = setup(remat="full", **TINY)
    jstep, tstep = j_step_fn(jm), t_step_fn(tm)
    jstate = jax.tree.map(jnp.asarray, j_make_train_state(jm, jax.random.PRNGKey(0)))
    batches = [make_batch(jcfg, ShapeConfig("t", 32, 2, "train"), step=s)
               for s in range(4)]
    for s in range(2):
        jstate, _ = jstep(jstate, jbatch(batches[s]))
    rmgr = RMgr(RStore(RConfig(**CFG)), shard_bytes=4096)
    rmgr.save(2, jstate)
    want = []
    for s in range(2, 4):
        jstate, met = jstep(jstate, jbatch(batches[s]))
        want.append(float(met["loss"]))

    tmgr = TMgr(port_store_on(rmgr.store.server), device="cpu", shard_bytes=4096)
    step, tstate = T.restore_train_state(tmgr, tm)
    assert step == 2 and int(tstate["opt"]["step"]) == 2
    got = []
    for s in range(2, 4):
        tstate, met = tstep(tstate, batches[s])
        got.append(float(met["loss"]))
    assert got == pytest.approx(want, rel=1e-4)


def test_reference_resumes_a_port_checkpoint():
    """The port trains 2 steps from JAX-made weights and saves; JAX restores
    that train state from the same server and continues as the port does."""
    jcfg, jm, jparams, tm, _tp = setup(remat="full", **TINY)
    jstep, tstep = j_step_fn(jm), t_step_fn(tm)
    jstate0 = j_make_train_state(jm, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate0), tm.cfg, CPU)
    batches = [make_batch(jcfg, ShapeConfig("t", 32, 2, "train"), step=s)
               for s in range(4)]
    for s in range(2):
        tstate, _ = tstep(tstate, batches[s])
    tmgr = small_mgr()
    T.save_train_state(tmgr, 2, tstate)
    want = []
    for s in range(2, 4):
        tstate, met = tstep(tstate, batches[s])
        want.append(float(met["loss"]))

    rmgr = RMgr(ref_store_on(tmgr.store.server), shard_bytes=4096)
    step, got = rmgr.restore(jax.eval_shape(lambda: jstate0))
    assert step == 2
    jstate = jax.tree.map(jnp.asarray, got)
    losses = []
    for s in range(2, 4):
        jstate, met = jstep(jstate, jbatch(batches[s]))
        losses.append(float(met["loss"]))
    assert losses == pytest.approx(want, rel=1e-4)
