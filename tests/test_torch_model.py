"""The port's dense transformer (``repro_torch.models``) against the JAX
package's on olmo_1b's scaled-down config in float32, with the JAX package's
weights carried over by ``models.convert.params_from_numpy``: prefill logits
and every cache leaf, decode steps, greedy tokens, and the cache's leaf
paths (the page store's keys).  Tolerance: the reference's model
cross-check, 3e-5."""
import dataclasses
import functools
import itertools
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.data import make_batch
from repro.models import get_model as j_get_model
from repro_torch import configs as configs_pkg
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import flatten_with_path

TOL = dict(rtol=3e-5, atol=3e-5)
CPU = torch.device("cpu")


def setup(dtype="float32", **kw):
    jcfg = dataclasses.replace(j_get_config("olmo_1b").scaled_down(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config("olmo_1b").scaled_down(), dtype=dtype, **kw)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), max_seq=96)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    return jcfg, jmodel, jparams, get_model(tcfg, CPU), tparams


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


def test_params_split_per_layer_and_keep_layout():
    jcfg, _jm, jparams, _tm, tparams = setup()
    assert len(tparams["layers"]) == jcfg.n_layers
    for i in (0, jcfg.n_layers - 1):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                tparams["layers"][i]["attn"][name].numpy(),
                np.asarray(jparams["layers"]["attn"][name][i]))
    assert tparams["final_norm"] == {} and tparams["layers"][0]["ln1"] == {}


def test_bf16_params_cross_bit_exact():
    _jcfg, _jm, jparams, _tm, tparams = setup(dtype="bfloat16")
    got = tparams["layers"][1]["mlp"]["wg"]
    want = np.asarray(jparams["layers"]["mlp"]["wg"][1])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_prefill_and_decode_match_reference():
    jcfg, jm, jparams, tm, tparams = setup()
    batch = make_batch(jcfg, ShapeConfig("t", 32, 2, "prefill"))
    jl, jc = jax.jit(jm.prefill)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, batch)
    assert tuple(tl.shape) == jl.shape == (2, 1, jcfg.vocab_size)
    close(tl, jl)
    jleaves = jax.tree_util.tree_flatten_with_path(jc)[0]
    tleaves = flatten_with_path(tc)
    assert [p for p, _ in tleaves] == [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (path, t), (_p, j) in zip(tleaves, jleaves):
        assert tuple(t.shape) == j.shape and t.dtype == getattr(torch, str(j.dtype)), path
        close(t, j)

    jdec = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl, dim=-1).to(torch.int32)
    for _ in range(4):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jc = jdec(jparams, jc, jtok)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, tc, ttok)
        close(tl, jl)
        for (path, t), (_p, j) in zip(flatten_with_path(tc),
                                      jax.tree_util.tree_flatten_with_path(jc)[0]):
            close(t, j)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tl, dim=-1).to(torch.int32)
    assert int(tc["pos"]) == int(jc["pos"]) == 36


def test_long_prompt_takes_chunked_attention_and_matches():
    """Above 512 tokens both packages run chunked attention on the CPU."""
    jcfg, jm, jparams, tm, tparams = setup(n_layers=2, attn_chunk=128)
    batch = make_batch(jcfg, ShapeConfig("t", 520, 1, "prefill"))
    jl, _ = jax.jit(jm.prefill)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, batch)
    close(tl, jl)
    assert tc["full"]["k"].shape == (2, 1, 520 + 128, 4, 32)


def test_init_cache_matches_reference_tree():
    jcfg, jm, _jp, tm, _tp = setup()
    jc = jm.init_cache(3, 40)
    tc = tm.init_cache(3, 40)
    for (path, t), (_p, j) in zip(flatten_with_path(tc),
                                  jax.tree_util.tree_flatten_with_path(jc)[0]):
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_port_init_draws_reference_shapes_and_scales():
    cfg = get_config("olmo_1b").scaled_down()
    params = get_model(cfg, CPU).init(0)
    again = get_model(cfg, CPU).init(torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(lambda: j_get_model(j_get_config("olmo_1b").scaled_down())
                             .init(jax.random.PRNGKey(0)))
    assert torch.equal(params["embed"]["table"], again["embed"]["table"])
    for i, layer in enumerate(params["layers"]):
        for group in ("attn", "mlp"):
            for name, leaf in layer[group].items():
                assert leaf.dtype == torch.bfloat16
                assert tuple(leaf.shape) == jshapes["layers"][group][name].shape[1:], \
                    (i, group, name)
    assert abs(float(params["embed"]["table"].float().std()) - 0.02) < 1e-3


#: every configuration of the port, the transformer's families and the rest
CONFIGS = sorted(m.name for m in pkgutil.iter_modules(configs_pkg.__path__) if m.name != "base")


@pytest.mark.parametrize("scale", ["full", "scaled_down"])
@pytest.mark.parametrize("arch", CONFIGS)
def test_layer_schedule_covers_the_tree_and_the_cache(arch, scale):
    """``transformer.schedule`` lays every layer out once, in forward order,
    in units of consecutive layers; each layer's block is in ``init``'s tree
    with its mixer and MLP or MoE, and each cache entry's leading dims are
    exactly its layers' slots.  Another family's config is refused."""
    cfg = get_config(arch)
    cfg = cfg if scale == "full" else cfg.scaled_down()
    if cfg.family not in TT.FAMILIES:
        with pytest.raises(ValueError, match="not the transformer's"):
            TT.schedule(cfg)
        return
    layers = TT.schedule(cfg)
    assert len(layers) == cfg.n_layers and len({l.path for l in layers}) == cfg.n_layers
    assert tuple(l.kind for l in layers) == TT.layer_plan(cfg)
    units = [l.unit for l in layers]
    assert units == sorted(units) and set(units) == set(range(units[-1] + 1))

    params = get_model(cfg, CPU).init_abstract()
    assert set(params) - {"embed", "final_norm"} == {l.path[0] for l in layers}
    for layer in layers:
        block = functools.reduce(lambda node, key: node[key], layer.path, params)
        assert ("ssm" if layer.kind == "mamba" else "attn") in block, layer
        assert ("moe" if layer.moe else "mlp") in block, layer

    cache = TT.init_cache(cfg, 1, 8, device="meta")
    assert set(cache) - {"pos"} == {l.entry for l in layers}
    for entry in set(cache) - {"pos"}:
        slots = [l.slot for l in layers if l.entry == entry]
        assert slots == sorted(slots) and len(set(slots)) == len(slots), entry
        for path, leaf in flatten_with_path(cache[entry]):
            lead = tuple(leaf.shape[:len(slots[0])])
            assert set(slots) == set(itertools.product(*map(range, lead))), (entry, path)
