"""The port's MoE layers (``repro_torch.models.layers.moe``) and the moe
family of its transformer against the JAX package's, on the CPU in float32
with the JAX package's weights carried over by
``models.convert.params_from_numpy``: capacity, routing (top-k indices,
the capacity keep-mask and the dispatch tensor, exactly, ties included),
``apply_moe`` within 2e-5, the auxiliary loss, prefill and decode logits
and caches within 3e-5 with greedy tokens exact, ``train_loss`` and every
gradient (the router's included) within 3e-5, and a granite_moe_3b
checkpoint crossing between the packages.  The configs: granite_moe_3b and
mixtral_8x22b (swa) scaled down, granite with 16 experts, top-8 and
``moe_group`` 16 (k = 8, several groups a row), and gemma3's local_global
pattern made MoE on its global layers."""
import dataclasses
import json

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
from repro.data import make_batch
from repro.models import get_model as j_get_model
from repro.models.layers import moe as JM
from repro_torch.checkpoint import ErdaCheckpointManager as TMgr
from repro_torch.configs import get_config
from repro_torch.core import ErdaStore as TStore
from repro_torch.core.client import ErdaClient as TClient
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy, to_reference_tree
from repro_torch.models.layers import moe as TM
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import flatten_with_path

TOL = dict(rtol=3e-5, atol=3e-5)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
CPU = torch.device("cpu")

#: (arch, overrides) of the slice's configs, scaled down
GRANITE = ("granite_moe_3b", {})
MIXTRAL = ("mixtral_8x22b", {})
GRANITE_K8 = ("granite_moe_3b", dict(n_experts=16, n_experts_active=8, moe_group=16))
LOCAL_GLOBAL_MOE = ("gemma3_27b", dict(n_layers=8, family="moe", n_experts=8,
                                       n_experts_active=2, d_ff=64))


def configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(j_get_config(arch).scaled_down(), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch).scaled_down(), dtype=dtype, **kw))


def setup(arch, dtype="float32", **kw):
    jcfg, tcfg = configs(arch, dtype, **kw)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    return jcfg, jmodel, jparams, get_model(tcfg, CPU), tparams


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **tol)


def jleaves(tree):
    return [(jax.tree_util.keystr(p), a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def exact_or_close(tree, jtree):
    tl, jl = flatten_with_path(tree), jleaves(jtree)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_p, j) in zip(tl, jl):
        assert tuple(t.shape) == j.shape and t.dtype == getattr(torch, str(j.dtype)), path
        if t.dtype == torch.int32:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)
        else:
            close(t, j)


# ------------------------------------------------------------------ the layer
def j_routing(params, x, cfg):
    """The reference's ``apply_moe`` up to its dispatch tensor (its own
    lines, ``repro/models/layers/moe.py:47-69``): top-k indices, the
    capacity keep-mask of each (token, slot) and dispatch (B, n, g, E, C)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    g = min(cfg.moe_group, S)
    while S % g:
        g //= 2
    n = S // g
    C = JM.capacity(cfg, g)
    xg = x.reshape(B, n, g, d)
    gates = jax.nn.softmax(xg.astype(jnp.float32) @ params["router"], axis=-1)
    _topv, topi = jax.lax.top_k(gates, k)
    onehot = jax.nn.one_hot(topi, E, dtype=jnp.float32)
    flat = onehot.reshape(B, n, g * k, E)
    pos = jnp.cumsum(flat, axis=2) - flat
    keep = (pos < C) * flat
    cap_oh = jax.nn.one_hot(pos.astype(jnp.int32), C, dtype=jnp.float32) * keep[..., None]
    dispatch = cap_oh.reshape(B, n, g, k, E, C).sum(3)
    return g, C, np.asarray(topi), np.asarray(keep.sum(-1).reshape(B, n, g, k)), \
        np.asarray(dispatch)


def t_dispatch(r: TM.Routing, E: int) -> np.ndarray:
    """The port's routing as the reference's (B, n, g, E, C) dispatch."""
    B, n, g, k = r.topi.shape
    out = np.zeros((B, n, g, E, r.C), np.float32)
    for idx in zip(*np.nonzero(r.keep.numpy())):
        b, m, s, j = idx
        out[b, m, s, int(r.topi[idx]), int(r.pos[idx])] = 1.0
    return out


def moe_layer(arch, kw, layer=0, seed=0):
    """(jcfg, tcfg, reference params, port params) of one MoE layer."""
    jcfg, jm, jparams, tm, tparams = setup(arch, **kw)
    jp = jax.tree.map(lambda a: a[layer], jparams["layers"]["moe"])
    return jcfg, tm.cfg, jp, tparams["layers"][layer]["moe"]


@pytest.mark.parametrize("arch,kw", [
    GRANITE, MIXTRAL, GRANITE_K8,
    ("granite_moe_3b", dict(capacity_factor=0.5)),
    ("granite_moe_3b", dict(n_experts=16, n_experts_active=8, moe_group=16,
                            capacity_factor=0.5)),
    ("granite_moe_3b", dict(n_experts=40, n_experts_active=8)),
    ("mixtral_8x22b", dict(capacity_factor=2.0))],
    ids=["granite", "mixtral", "granite-k8", "granite-cf0.5", "granite-k8-cf0.5",
         "granite-40e-top8", "mixtral-cf2"])
def test_capacity_equals_reference(arch, kw):
    jcfg, tcfg = configs(arch, **kw)
    got = [TM.capacity(tcfg, g) for g in range(1, 1025)]
    assert got == [JM.capacity(jcfg, g) for g in range(1, 1025)]


@pytest.mark.parametrize("arch,kw,S", [
    (*GRANITE, 48), (*MIXTRAL, 48), (*GRANITE_K8, 48),
    ("granite_moe_3b", dict(moe_group=16), 24),        # g halves: 16 -> 8
    ("granite_moe_3b", dict(capacity_factor=0.5), 48),  # tokens dropped
    (*GRANITE_K8[:1], dict(GRANITE_K8[1], capacity_factor=0.5), 40)],
    ids=["granite", "mixtral", "granite-k8", "granite-S24-g8", "granite-cf0.5",
         "granite-k8-cf0.5"])
def test_apply_moe_and_routing_match_reference(arch, kw, S):
    jcfg, tcfg, jp, tp = moe_layer(arch, kw)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    g, C, topi, keep, dispatch = j_routing(jp, jnp.asarray(x), jcfg)
    r = TM.route(tp, torch.from_numpy(x), tcfg)
    assert (r.g, r.C) == (g, C)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.keep.numpy(), keep.astype(bool))
    np.testing.assert_array_equal(t_dispatch(r, tcfg.n_experts), dispatch)
    if kw.get("capacity_factor", 1.25) < 1:
        assert not keep.all()  # some pairs were dropped
    if S == 24:
        assert g == 8
    want = JM.apply_moe(jp, jnp.asarray(x), jcfg)
    got = TM.apply_moe(tp, torch.from_numpy(x), tcfg)
    close(got, want, LAYER_TOL)


def test_ties_take_the_lower_expert_index_first():
    """Experts 2 and 5 (and 3 and 6) have identical router columns, so their
    gates tie exactly in both packages.  Where a tied pair shares the k-th
    place, the reference's ``top_k`` takes the lower index, and so does the
    port; in groups of 4 with capacity 1 a choice also decides which later
    tokens lose their slot."""
    jcfg, tcfg, jp, tp = moe_layer(*GRANITE)
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 3]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, jcfg.d_model)).astype(np.float32)
    jcfg = dataclasses.replace(jcfg, moe_group=4, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, moe_group=4, capacity_factor=0.5)
    _g, C, topi, keep, dispatch = j_routing(jp, jnp.asarray(x), jcfg)
    r = TM.route(tp, torch.from_numpy(x), tcfg)
    decided = [((topi == lo).any(-1) & ~(topi == hi).any(-1)) for lo, hi in ((2, 5), (3, 6))]
    lost = [((topi == hi).any(-1) & ~(topi == lo).any(-1)) for lo, hi in ((2, 5), (3, 6))]
    assert C == 1 and any(d.any() for d in decided) and not any(l.any() for l in lost)
    assert not keep.all()
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(r.keep.numpy(), keep.astype(bool))
    np.testing.assert_array_equal(t_dispatch(r, tcfg.n_experts), dispatch)
    close(TM.apply_moe(tp, torch.from_numpy(x), tcfg),
          JM.apply_moe(jp, jnp.asarray(x), jcfg), LAYER_TOL)
    # the rule itself, on equal values: the lower index first
    _v, i = TM.top_k(torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]]), 3)
    assert i.tolist() == [[1, 2, 4]]


@pytest.mark.parametrize("arch,kw", [GRANITE, GRANITE_K8], ids=["granite", "granite-k8"])
def test_aux_loss_and_its_gradient_match_reference(arch, kw):
    jcfg, tcfg, jp, tp = moe_layer(arch, kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    jl, (jgr, jgx) = jax.value_and_grad(
        lambda p, xx: JM.aux_load_balance_loss(p, xx, jcfg), argnums=(0, 1))(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    router = tp["router"].clone().requires_grad_(True)
    tl = TM.aux_load_balance_loss(dict(tp, router=router), tx, tcfg)
    tl.backward()
    close(tl, jl, LAYER_TOL)
    close(router.grad, jgr["router"], LAYER_TOL)
    close(tx.grad, jgx, LAYER_TOL)


def test_init_moe_draws_the_reference_shapes_and_dtypes():
    """granite_moe_3b at its full config on the meta device: every layer's
    ``moe`` block has the reference's leaves (the router in float32), and
    the tree counts the config's parameters plus the norms' scales."""
    cfg = get_config("granite_moe_3b")
    params = get_model(cfg, CPU).init_abstract()
    want = jax.eval_shape(lambda: JM.init_moe(j_get_config("granite_moe_3b"),
                                              jax.random.PRNGKey(0)))
    for name, leaf in params["layers"][0]["moe"].items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype) == f"torch.{want[name].dtype}", name
    assert "mlp" not in params["layers"][0]
    n = sum(t.numel() for _p, t in flatten_with_path(params))
    assert n == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model
    assert n == 3_298_693_632 + 99_840


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("arch,kw,S", [
    (*GRANITE, 32), (*MIXTRAL, 80), (*GRANITE_K8, 48), (*LOCAL_GLOBAL_MOE, 80)],
    ids=["granite", "mixtral-S80", "granite-k8", "local_global-moe"])
def test_prefill_and_decode_match_reference(arch, kw, S):
    """Prefill (mixtral past its 64-token window: banded attention) and four
    greedy decode steps: logits and every cache leaf within 3e-5, tokens
    exact."""
    jcfg, jm, jparams, tm, tparams = setup(arch, **kw)
    batch = make_batch(jcfg, ShapeConfig("t", S, 2, "prefill"))
    jl, jc = jax.jit(jm.prefill)(jparams, jbatch(batch))
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, batch)
    assert tuple(tl.shape) == jl.shape == (2, 1, jcfg.vocab_size)
    close(tl, jl)
    exact_or_close(tc, jc)
    jdec = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl, dim=-1).to(torch.int32)
    for _ in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jdec(jparams, jc, jtok)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, tc, ttok)
        close(tl, jl)
        exact_or_close(tc, jc)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch,kw,S,remat", [
    (*GRANITE, 32, "full"), (*MIXTRAL, 80, "none"), (*GRANITE_K8, 48, "full"),
    (*LOCAL_GLOBAL_MOE, 80, "full")],
    ids=["granite-remat", "mixtral-S80", "granite-k8-remat", "local_global-moe-remat"])
def test_train_loss_and_every_gradient_match_reference(arch, kw, S, remat):
    """The loss with its 0.01 · aux / n_layers term, and every gradient (the
    routers' included: through the gates, the combine weights and the aux
    loss), within 3e-5."""
    jcfg, jm, jparams, tm, tparams = setup(arch, remat=remat, **kw)
    batch = make_batch(jcfg, ShapeConfig("t", S, 2, "train"))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(jparams, jbatch(batch))
    tloss, tgrads = loss_and_grads(tm.train_loss, tparams, batch)
    close(tloss, jloss)
    tl, jl = flatten_with_path(to_reference_tree(tgrads)), jleaves(jgrads)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    assert any("['moe']['router']" in p for p, _ in tl)
    for (path, g), (_p, j) in zip(tl, jl):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=path, **TOL)


def test_aux_term_is_in_the_loss():
    """The backbone's summed aux loss equals the reference's, and
    train_loss is the LM loss plus 0.01 · aux / n_layers."""
    from repro.models import transformer as JT
    from repro.models.layers import basic as JB
    from repro_torch.models import transformer as TT
    from repro_torch.models.layers import basic as TB
    jcfg, jm, jparams, tm, tparams = setup(*GRANITE)
    batch = make_batch(jcfg, ShapeConfig("t", 32, 2, "train"))
    x, pos = JT._embed_inputs(jcfg, jparams, jbatch(batch))
    jx, _kv, jaux = JT._backbone(jcfg, jparams, x, pos, collect_kv=False)
    with torch.no_grad():
        tx, tpos = TT._embed_inputs(tm.cfg, tparams, batch)
        tx, _kv, taux = TT._backbone(tm.cfg, tparams, tx, tpos, train=True)
        total = tm.train_loss(tparams, batch)
        lm = TB.lm_loss_chunked(tparams["embed"],
                                TB.apply_norm(tparams["final_norm"], tx, tm.cfg.norm),
                                torch.as_tensor(batch["tokens"]), chunk=tm.cfg.loss_chunk)
    assert float(jaux) > 0
    close(taux, jaux)
    close(total, lm + 0.01 * taux / jcfg.n_layers)
    jlm = JB.lm_loss_chunked(jparams["embed"], JB.apply_norm(jparams["final_norm"], jx, jcfg.norm),
                             jbatch(batch)["tokens"], chunk=jcfg.loss_chunk)
    close(lm, jlm)


# ------------------------------------------------------------- checkpoints
CFG = dict(device_size=64 << 20, table_capacity=1 << 12, n_heads=2,
           region_size=8 << 20, segment_size=1 << 20)


def port_store_on(server):
    s = object.__new__(TStore)
    s.server, s.dev = server, server.dev
    s.client = TClient(server, device="cpu")
    return s


def test_granite_checkpoint_crosses_packages():
    """granite_moe_3b scaled down in bf16 (one layer, d_ff 16, vocab 128:
    the port's restore verifies every byte with the plain CRC loop on the
    CPU): the reference saves its parameters, the port restores them bit for
    bit (the ``moe`` leaves stacked as (L, E, d, f), the router in float32),
    then saves its own and the reference restores those bit for bit, all on
    one server."""
    jcfg, jm, jparams, tm, tparams = setup(GRANITE[0], dtype="bfloat16", n_layers=1,
                                           d_ff=16, vocab_size=128)
    rmgr = RMgr(RStore(RConfig(**CFG)), shard_bytes=1 << 14)
    rmgr.save(5, jparams)
    tmgr = TMgr(port_store_on(rmgr.store.server), device="cpu", shard_bytes=1 << 14)
    step, got = tmgr.restore(to_reference_tree(tm.init_abstract()))
    assert step == 5
    paths = [p for p, _ in flatten_with_path(got)]
    assert paths == [p for p, _ in jleaves(jparams)]
    assert got["layers"]["moe"]["wg"].shape == (1, 8, 128, 16)
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    for (p, t), (_q, j) in zip(flatten_with_path(got), jleaves(jparams)):
        want = np.asarray(j)
        have = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(have, want.view(np.int16) if t.dtype == torch.bfloat16
                                      else want, err_msg=p)

    tmgr.save(6, to_reference_tree(tparams))
    step, back = rmgr.restore(jax.eval_shape(lambda: jparams))
    assert step == 6
    manifest = json.loads(bytes(rmgr.store.read(0x3A5F00D)).decode())
    assert "['layers']['moe']['wo']" in [e["path"] for e in manifest["entries"]]
    for (p, a), (_q, b) in zip(jleaves(back), jleaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8), err_msg=p)


@pytest.mark.parametrize("arch,kw", [MIXTRAL, GRANITE_K8], ids=["mixtral", "granite-k8"])
def test_decode_matches_prefill_without_drops(arch, kw):
    """``tests/test_models_smoke.py::test_decode_matches_prefill`` on the
    port: decoding token S against prefill(0..S-1)'s cache gives
    prefill(0..S)'s logits, with a capacity (factor 8) that drops nothing,
    since drops legitimately differ between the two."""
    _jc, tcfg = configs(arch, capacity_factor=8.0, **kw)
    model = get_model(tcfg, CPU)
    params = model.init(0)
    S = 16
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, size=(2, S + 1))
    toks = torch.from_numpy(toks.astype(np.int32))
    with torch.inference_mode():
        _la, cache = model.prefill(params, {"tokens": toks[:, :S]})
        lb, _cb = model.prefill(params, {"tokens": toks})
        ld, _cd = model.decode_step(params, cache, toks[:, S:])
    close(ld, lb.numpy())
