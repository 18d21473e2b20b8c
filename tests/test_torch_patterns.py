"""The port's swa and local_global patterns, int8 KV cache and vlm family
(``repro_torch.models.transformer``) against the JAX package's, on the CPU
in float32 with the JAX package's weights carried over by
``models.convert.params_from_numpy``: prefill logits, every cache leaf and
four decode steps past the ring's wrap, the int8 cache's replay, train
losses with every gradient, the parameter and train-state trees, decode
caches crossing between the packages through the page store, and a
preempted serving run.  Tolerance: the reference's model cross-check, 3e-5;
caches and int8 leaves exactly where the reference is exact."""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig
from repro.core import ErdaStore as RStore
from repro.core import ServerConfig as RConfig
from repro.core.client import ErdaClient as RClient
from repro.data import make_batch
from repro.models import get_model as j_get_model
from repro.models import transformer as JT
from repro.serving import ErdaKVPageStore as RPages
from repro.train.step import make_train_state as j_make_train_state
from repro_torch.checkpoint import ErdaCheckpointManager as TMgr
from repro_torch.configs import get_config
from repro_torch.core import ErdaStore as TStore
from repro_torch.core import ServerConfig as TConfig
from repro_torch.core.client import ErdaClient as TClient
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as T
from repro_torch.models import get_model
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (from_reference_tree, params_from_numpy,
                                        to_reference_tree, train_state_from_numpy)
from repro_torch.serving import ErdaKVPageStore as TPages
from repro_torch.serving import ServeEngine
from repro_torch.serving.kv_store import MAX_SHARD_BYTES, page_shard_config
from repro_torch.train.step import (loss_and_grads, make_train_state,
                                    make_train_state_abstract)
from repro_torch.tree import flatten_with_path

TOL = dict(rtol=3e-5, atol=3e-5)
CPU = torch.device("cpu")

#: the configurations of this slice, scaled down: (arch, overrides).
#: gemma3's scaled_down() is one group of 5 local + 1 global layer; 8
#: layers add the two-layer tail (as in gemma3_27b's 62 = 10 x 6 + 2)
LOCAL_GLOBAL = ("gemma3_27b", dict(n_layers=8))
SWA = ("olmo_1b", dict(attn_pattern="swa", window=64))
PIXTRAL = ("pixtral_12b", {})


def setup(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(j_get_config(arch).scaled_down(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config(arch).scaled_down(), dtype=dtype, **kw)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, CPU)
    return jcfg, jmodel, jparams, get_model(tcfg, CPU), tparams


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL)


def jleaves(tree):
    return [(jax.tree_util.keystr(p), a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def exact_or_close(tree, jtree):
    """Same paths, shapes and dtypes; positions and int8 leaves exact, the
    rest within 3e-5."""
    tl, jl = flatten_with_path(tree), jleaves(jtree)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_p, j) in zip(tl, jl):
        assert tuple(t.shape) == j.shape and t.dtype == getattr(torch, str(j.dtype)), path
        if t.dtype in (torch.int8, torch.int32):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)
        else:
            close(t, j)


@pytest.mark.parametrize("arch,kw,S", [
    (*LOCAL_GLOBAL, 48),     # S < W: every layer causal, rings not yet full
    (*LOCAL_GLOBAL, 160),    # S > W: banded local layers, ring shift 32
    ("gemma3_12b", {}, 96),  # one group, no tail
    (*SWA, 100),
    (*PIXTRAL, 24),          # 8 patch embeddings before 24 tokens
], ids=["local_global-S48", "local_global-S160", "gemma3_12b", "swa", "pixtral"])
def test_prefill_and_decode_match_reference(arch, kw, S):
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
    assert int(tc["pos"]) == int(jc["pos"]) == S + (jcfg.n_patches or 0) + 4


def test_local_global_cache_tree_holds_the_reference_shapes():
    """(G, lpg, W) positions under local, (G, C) under full, (rem, W) under
    tail: the leaf shapes the page keys are derived from."""
    _jcfg, jm, _jp, tm, _tp = setup(LOCAL_GLOBAL[0], **LOCAL_GLOBAL[1])
    tc, jc = tm.init_cache(2, 40), jm.init_cache(2, 40)
    assert tc["local"]["kv_pos"].shape == (1, 5, 64)
    assert tc["full"]["kv_pos"].shape == (1, 40 + 128)
    assert tc["tail"]["kv_pos"].shape == (2, 64)
    assert tc["local"]["k"].shape == (1, 5, 2, 64, 2, 32)
    exact_or_close(tc, jc)


#: how near a half-integer (in quantization steps) a value must lie for
#: float32 noise between the two packages' products to decide its rounding
TIE = 1e-4


def test_int8_quantizer_is_the_reference_bit_for_bit():
    """Same inputs, same int8 values and bf16 scales, the jitted reference
    and the port, ties at exact half steps rounding to even."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, 2, 32)).astype(np.float32)
    x[0, 0, 0, :3] = [127.0, 0.5, -2.5]  # scale 1: ties at .5 and -2.5
    x[1] = 0.0  # all-zero rows take the 1e-8 floor
    jq, js = jax.jit(JT._quantize_kv)(jnp.asarray(x))
    tq, ts = TT._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    assert tq[0, 0, 0, :3].tolist() == [127, 0, -2]


@pytest.mark.parametrize("arch,kw", [("mistral_nemo_12b", {}), LOCAL_GLOBAL],
                         ids=["dense", "local_global"])
def test_int8_cache_replay_matches_reference(arch, kw, monkeypatch):
    """``tests/test_models_smoke.py``'s int8 replay: 16 tokens and one more
    through decode from ``init_cache(2, 0)`` with ``cache_quant``.  Full
    caches are int8 with bf16 scales, ring caches keep the model's dtype,
    as the reference's.  Every step: logits within 3e-5 and every leaf
    exact.  The port quantizes each new K/V itself; where its int8 differs
    from the reference's, the value must lie within ``TIE`` of a half step
    (float32 noise between two BLAS libraries decides such a rounding) and
    differ by one — there the reference's rounding is carried on, so the
    comparison of the following steps starts from the same cache.  A second
    replay, the port's own throughout, matches at every step before the
    first such tie.  The ties are no more than the
    values that lie within ``TIE`` of a half step by chance, a share of
    2 * ``TIE`` (here one, at step 8 of the dense replay)."""
    jcfg, jm, jparams, tm, tparams = setup(arch, cache_quant=True, **kw)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 17)).astype(np.int32)
    jc, tc = jm.init_cache(2, 0), tm.init_cache(2, 0)
    assert tc["full"]["k"].dtype == torch.int8
    assert tc["full"]["k_scale"].dtype == torch.bfloat16
    quantize, tie_steps, want, step = TT._quantize_kv, [], [], [0]

    def reference_rounding(t):
        q, scale = quantize(t)
        ref = torch.from_numpy(want.pop(0))
        diff = q != ref
        if not diff.any():
            return q, scale
        tf = t.float()
        ratio = tf / torch.clamp(tf.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
        frac = (ratio - ratio.floor())[diff]
        assert bool(((q.int() - ref.int()).abs()[diff] == 1).all())
        assert bool(((frac - 0.5).abs() < TIE).all()), frac
        tie_steps.extend([step[0]] * int(diff.sum()))
        return ref, scale

    monkeypatch.setattr(TT, "_quantize_kv", reference_rounding)
    jdec = jax.jit(jm.decode_step)
    reference = []
    for t in range(17):
        step[0] = t
        jl, jc = jdec(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        reference.append((jl, jc))
        # the reference's new int8 K and V of each quantizing layer, in the
        # order the port quantizes them
        want[:] = [np.asarray(jc["full"][name][g, :, t:t + 1])
                   for g in range(jc["full"]["k"].shape[0]) for name in ("k", "v")]
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]))
        assert not want
        close(tl, jl)
        exact_or_close(tc, jc)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(tc["full"][name].view(torch.int16).numpy(),
                                          np.asarray(jc["full"][name]).view(np.int16))
    assert int(tc["full"]["k"].abs().max()) == 127
    if "local" in tc:
        assert "k_scale" not in tc["local"] and tc["local"]["k"].dtype == torch.float32
    quantized = 2 * tc["full"]["k"][:, :, :17].numel()
    assert len(tie_steps) <= max(1, 2 * TIE * quantized), (len(tie_steps), quantized)

    monkeypatch.undo()
    tc = tm.init_cache(2, 0)
    for t in range(min(tie_steps, default=17)):
        with torch.inference_mode():
            tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(toks[:, t:t + 1]))
        close(tl, reference[t][0])
        exact_or_close(tc, reference[t][1])


def test_int8_prefill_cache_carries_no_scales():
    """The reference quantizes only a cache ``init_cache`` made: a prefill
    cache has no ``k_scale``, so decode keeps it in the model's dtype."""
    jcfg, jm, jparams, tm, tparams = setup("mistral_nemo_12b", cache_quant=True)
    batch = make_batch(jcfg, ShapeConfig("t", 16, 2, "prefill"))
    jl, jc = jax.jit(jm.prefill)(jparams, jbatch(batch))
    jl, jc = jax.jit(jm.decode_step)(jparams, jc, jnp.argmax(jl, -1).astype(jnp.int32))
    with torch.inference_mode():
        tl, tc = tm.prefill(tparams, batch)
        tl, tc = tm.decode_step(tparams, tc, torch.argmax(tl, -1).to(torch.int32))
    close(tl, jl)
    exact_or_close(tc, jc)
    assert set(tc["full"]) == {"k", "v", "kv_pos"} and tc["full"]["k"].dtype == torch.float32


@pytest.mark.parametrize("arch,kw,S,remat", [
    (*LOCAL_GLOBAL, 160, "full"), (*LOCAL_GLOBAL, 48, "none"), (*PIXTRAL, 24, "full")],
    ids=["local_global-S160-remat", "local_global-S48", "pixtral-remat"])
def test_train_loss_and_every_gradient_match_reference(arch, kw, S, remat):
    jcfg, jm, jparams, tm, tparams = setup(arch, remat=remat, **kw)
    batch = make_batch(jcfg, ShapeConfig("t", S, 2, "train"))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(jparams, jbatch(batch))
    tloss, tgrads = loss_and_grads(tm.train_loss, tparams, batch)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    tl, jl = flatten_with_path(to_reference_tree(tgrads)), jleaves(jgrads)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, g), (_p, j) in zip(tl, jl):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=path, **TOL)


def test_reference_trees_round_trip_with_keystr_paths():
    """local_global's parameters and train state: stacked by
    ``to_reference_tree`` into the reference's leaves and paths, split back
    by ``from_reference_tree``; ``init_abstract`` has the same shapes."""
    jcfg, jm, _jp, tm, _tp = setup(LOCAL_GLOBAL[0], **LOCAL_GLOBAL[1])
    state = make_train_state(tm, 3)
    assert len(state["params"]["local_layers"]) == 1
    assert len(state["params"]["local_layers"][0]) == 5
    assert len(state["params"]["tail_local"]) == 2
    ref = to_reference_tree(state)
    assert ref["params"]["local_layers"]["attn"]["wq"].shape == (1, 5, 128, 128)
    assert ref["opt"]["m"]["tail_local"]["mlp"]["wo"].shape == (2, 256, 128)
    want = jleaves(jax.eval_shape(lambda: j_make_train_state(jm, jax.random.PRNGKey(0))))
    got = flatten_with_path(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, t), (_q, w) in zip(got, want):
        assert tuple(t.shape) == w.shape and str(t.dtype) == f"torch.{w.dtype}", p
    abstract = flatten_with_path(to_reference_tree(make_train_state_abstract(tm)))
    assert [(p, tuple(t.shape)) for p, t in abstract] == [(p, w.shape) for p, w in want]
    back = from_reference_tree(ref)
    for (p, a), (_q, b) in zip(flatten_with_path(state), flatten_with_path(back)):
        assert torch.equal(a, b), p


def test_train_state_from_numpy_takes_the_vlm_and_local_global_states():
    for arch, kw in (LOCAL_GLOBAL, PIXTRAL):
        jcfg, jm, _jp, tm, _tp = setup(arch, **kw)
        jstate = j_make_train_state(jm, jax.random.PRNGKey(1))
        tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tm.cfg, CPU)
        for (p, t), (_q, j) in zip(flatten_with_path(to_reference_tree(tstate)),
                                   jleaves(jstate)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=p)


@pytest.mark.parametrize("arch", ["gemma3_27b", "pixtral_12b"])
def test_trainer_resumes_the_new_trees(arch):
    """``launch.train`` on the local_global and vlm trees: a checkpoint at
    step 3 (the reference's stacked leaves), then a fresh trainer restores
    it and repeats steps 4-5 with the same losses."""
    store = TStore(TConfig(device_size=128 << 20, table_capacity=1 << 12, n_heads=2,
                           region_size=8 << 20, segment_size=1 << 20), device="cpu")
    mgr = TMgr(store, device="cpu", shard_bytes=4096)
    kw = dict(arch=arch, scale="smoke", steps=5, batch=2, seq=32, ckpt_mgr=mgr,
              log_every=0, device="cpu")
    _s, losses, _ = T.train(ckpt_every=3, **kw)
    _s, resumed, _ = T.train(resume=True, **kw)
    assert resumed == losses[-2:]


# ------------------------------------------------- caches through the store
CFG = dict(device_size=16 << 20, table_capacity=1 << 10, n_heads=2,
           region_size=2 << 20, segment_size=512 << 10)


def store_on(server, side: str):
    """A store of package ``side`` whose client is connected to ``server``."""
    cls, client = (TStore, TClient) if side == "port" else (RStore, RClient)
    s = object.__new__(cls)
    s.server, s.dev = server, server.dev
    s.client = client(server, device="cpu") if side == "port" else client(server)
    return s


def small_cache(arch, kw, S):
    jcfg, jm, jparams, tm, tparams = setup(arch, **kw)
    batch = make_batch(jcfg, ShapeConfig("t", S, 1, "prefill"))
    _jl, jc = jax.jit(jm.prefill)(jparams, jbatch(batch))
    with torch.inference_mode():
        _tl, tc = tm.prefill(tparams, batch)
    return jc, tc


def test_reference_cache_snapshot_restores_in_the_port():
    jc, tc = small_cache(*LOCAL_GLOBAL, 80)
    rstore = RStore(RConfig(**CFG))
    assert RPages(rstore).snapshot_cache(7, jc) == len(flatten_with_path(tc))
    got = TPages(store_on(rstore.server, "port"), device="cpu").restore_cache(7, tc)
    for (p, t), (_q, j) in zip(flatten_with_path(got), jleaves(jc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=p)


def test_port_cache_snapshot_restores_in_the_reference():
    jc, tc = small_cache(*SWA, 80)
    tstore = TStore(TConfig(**CFG), device="cpu")
    TPages(tstore, device="cpu").snapshot_cache(3, tc)
    got = RPages(store_on(tstore.server, "reference")).restore_cache(3, jc)
    for (p, t), (_q, j) in zip(flatten_with_path(tc), jleaves(got)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=p)


def test_preempted_local_global_run_equals_the_clean_one():
    """``tests/test_serving.py``'s preemption on the local_global config
    (bf16, 8 layers, a prompt past the window): the preempted engine
    restores its ring caches from a page store sized by ``page_store_for``
    and decodes the clean run's tokens."""
    cfg = dataclasses.replace(get_config("gemma3_27b").scaled_down(), n_layers=8)
    model = get_model(cfg, CPU)
    params = model.init(0)
    batch = make_batch(cfg, ShapeConfig("t", 72, 1, "prefill"))

    def run(crash_at):
        pages = tserve.page_store_for(cfg, 1, 72, 10, 4, CPU)
        engine = ServeEngine(model, params, page_store=pages, snapshot_every=4,
                             device=CPU)
        return engine.generate(batch, 10, crash_at=crash_at), engine

    clean, _ = run(None)
    crashy, engine = run(6)
    assert clean.shape == (1, 10)
    np.testing.assert_array_equal(clean, crashy)
    assert engine.pages.stats["reads"] > 0


def test_page_store_for_gemma3_27b_fits_the_31_bit_offsets():
    """gemma3_27b's decode cache at 1 x 1536 tokens: the largest leaf is
    ['local']['k'] (10, 5, 1, 1024, 16, 128) bf16, one version holds
    572,522,496 bytes of K/V, and one shard holds the three snapshots of a
    preempted 16-token run under the atomic word's 31-bit offsets; at 2
    requests it could not, and the sizing says so."""
    cfg = get_config("gemma3_27b")
    pages = dict(tserve.snapshot_pages(cfg, 1, 1536, 16))
    assert pages["['local']['k']"] == 10 * 5 * 1024 * 16 * 128 * 2 == 209_715_200
    assert sum(n for p, n in pages.items() if p.endswith(("['k']", "['v']"))) \
        == 572_522_496
    shard = page_shard_config(list(pages.items()), 3)
    assert shard.device_size <= MAX_SHARD_BYTES < 1 << 31 and shard.n_heads == 1
    # a segment holds one snapshot: 3 of them take 1.72 GB, not 2 GiB
    assert 572_522_496 < shard.segment_size == shard.region_size < 574 << 20
    assert shard.device_size < 3 * (574 << 20) + (1 << 20)
    with pytest.raises(ValueError, match="31-bit"):
        page_shard_config(tserve.snapshot_pages(cfg, 2, 1536, 16), 3)


def test_one_shard_holds_every_snapshot_of_a_run():
    """However the cluster routes the keys: every page of every version the
    run writes lands on one shard of ``page_shard_config``'s geometry, and
    the last version restores."""
    cfg = dataclasses.replace(get_config("gemma3_27b").scaled_down(), n_layers=8)
    model = get_model(cfg, CPU)
    params = model.init(0)
    with torch.inference_mode():
        _l, cache = model.prefill(params, make_batch(cfg, ShapeConfig("t", 72, 1, "prefill")))
    versions = -(-(10 - 1) // 4) + 1
    store = TStore(page_shard_config(tserve.snapshot_pages(cfg, 1, 72, 10), versions),
                   device="cpu")
    pages = TPages(store, device="cpu")
    for v in range(versions):
        pages.snapshot_cache(0, cache)
        pages.put_page(0, "__tokens__", 0, torch.zeros(1, 10, dtype=torch.int32))
    got = pages.restore_cache(0, cache)
    for (p, a), (_q, b) in zip(flatten_with_path(got), flatten_with_path(cache)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("seed,keep", [(0, 1.0), (1, 0.8), (2, 0.8), (3, 0.5)])
def test_any_routing_of_the_snapshots_fits_one_shard(seed, keep):
    """A log that starts a fresh segment for a record that does not fit can
    take more segments for part of a sequence than for all of it: whatever
    part of each of the ``versions`` snapshots a routing sends to one shard,
    the pages fit ``page_shard_config``'s geometry.  Each page is routed
    here with probability ``keep``."""
    rng = np.random.default_rng(seed)
    pages = [(str(i), int(n)) for i, n in enumerate(rng.integers(1, 4 << 20, 7))]
    versions = 3
    store = TStore(page_shard_config(pages, versions), device="cpu")
    for _v in range(versions):
        for i, (_name, n) in enumerate(pages):
            if rng.random() < keep:
                store.write(2 * i + 1, bytes(n))


def test_vlm_and_local_global_serve_through_the_launcher():
    for arch in ("pixtral_12b", "gemma3_12b"):
        out = tserve.serve(arch, batch=1, prompt_len=8, tokens=3,
                           snapshot_every=1, crash_at=1, device="cpu")
        assert out.shape == (1, 3)


#: the layouts ``test_torch_hybrid_moe.DEFAULT_DIGESTS`` lacks, scaled
#: down: local_global with its tail, swa with MoE and hybrid_moe with each
#: mixer twice, windows of 16 so that the 20-token prompt wraps the rings
LAYOUTS = {"local_global": ("gemma3_27b", dict(n_layers=8, window=16)),
           "swa_moe": ("mixtral_8x22b", dict(window=16)),
           "hybrid_moe": ("granite_h_small", dict(
               n_layers=4, layer_types=("mamba", "attention", "mamba", "attention")))}
#: sha256 (first 16 hex digits) of the seeded parameters, the prefill
#: logits, three decode steps' logits, the last cache's paths and leaves
#: and the train loss, one thread, recorded on the tree before the layer
#: schedule (``transformer.schedule``) replaced the per-pattern branches
LAYOUT_DIGESTS = {("local_global", "bfloat16"): "e5107a0093a77bab",
                  ("local_global", "float32"): "b2790edbe748e7a4",
                  ("swa_moe", "bfloat16"): "c12ad1ed38e29835",
                  ("swa_moe", "float32"): "35233ab0a01e5862",
                  ("hybrid_moe", "bfloat16"): "1bb2251a7192564b",
                  ("hybrid_moe", "float32"): "d6ff27b9041056af"}


@pytest.mark.parametrize("layout,dtype", sorted(LAYOUT_DIGESTS))
def test_layouts_keep_their_numbers_bit_for_bit(layout, dtype):
    arch, kw = LAYOUTS[layout]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype=dtype, **kw)
        model = get_model(cfg, CPU)
        params = model.init(0)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 24)).astype(np.int32))
        h = hashlib.sha256()
        for path, leaf in flatten_with_path(params):
            h.update(path.encode() + leaf.float().numpy().tobytes())
        with torch.inference_mode():
            logits, cache = model.prefill(params, {"tokens": toks[:, :20]})
            h.update(logits.float().numpy().tobytes())
            for i in range(20, 23):
                logits, cache = model.decode_step(params, cache, toks[:, i:i + 1])
                h.update(logits.float().numpy().tobytes())
        for path, leaf in flatten_with_path(cache):
            h.update(path.encode() + str(leaf.dtype).encode() + leaf.float().numpy().tobytes())
        h.update(model.train_loss(params, {"tokens": toks}).detach().float().numpy().tobytes())
    finally:
        torch.set_num_threads(threads)
    assert h.hexdigest()[:16] == LAYOUT_DIGESTS[layout, dtype]
