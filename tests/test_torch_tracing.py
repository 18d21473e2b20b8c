"""The port's span recorder (``repro_torch.tracing``) on the CPU: off, it
records nothing and changes no result; on, its spans nest as the layers
call each other, its MoE counters equal a recount from the routing, and
the store's own counters still equal the JAX package's."""
import dataclasses

import pytest
import torch

from repro.core import ServerConfig as RConfig
from repro.core import make_store as r_make_store
from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ServerConfig as TConfig
from repro_torch.core import make_store as t_make_store
from repro_torch.data import make_batch
from repro_torch.models import get_model
from repro_torch.models.layers import moe as M
from repro_torch.optim import AdamWConfig
from repro_torch.serving import ServeEngine
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.tree import flatten_with_path

CPU = torch.device("cpu")
#: small enough that a snapshot's cache leaves CRC-verify in well under a
#: second with the kernel's plain CPU version
TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=128)


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def tiny(arch="olmo_1b", **kw):
    return dataclasses.replace(get_config(arch).scaled_down(), **TINY, **kw)


def generate(cfg, crash_at=3, seq_id=5, tokens=8):
    model = get_model(cfg, CPU)
    engine = ServeEngine(model, model.init(0), snapshot_every=2, device=CPU)
    batch = make_batch(cfg, ShapeConfig("t", 8, 1, "prefill"))
    return engine.generate(batch, tokens, seq_id=seq_id, crash_at=crash_at)


def train_steps(cfg, n=2):
    model = get_model(cfg, CPU)
    step = make_train_step(model, AdamWConfig())
    state = make_train_state(model, 0, max_seq=16)
    losses = []
    for i in range(n):
        state, metrics = step(state, make_batch(cfg, ShapeConfig("t", 16, 2, "train"), i))
        losses.append(float(metrics["loss"]))
    return state, losses


def by_id(spans):
    return {s.id: s for s in spans}


def ancestry(span, ids):
    out = [span.name]
    while span.parent is not None:
        span = ids[span.parent]
        out.append(span.name)
    return out


def test_off_records_nothing_and_allocates_no_span():
    assert tracing.span("a", bytes=3) is tracing.NULL_SPAN
    with tracing.span("a") as s:
        s.add(bytes=1)
        tracing.count("c", 5)
    assert tracing.take() == ([], {})


def test_spans_nest_and_counts_attach_to_the_innermost_open_span():
    tracing.enable()
    with tracing.span("outer", request=9, rows=2) as outer:
        with tracing.span("inner"):
            tracing.count("hits", torch.tensor(3))
            tracing.count("hits", 4)
        outer.add(rows=1)
    tracing.count("hits", 1)
    spans, counters = tracing.take()
    assert [s.name for s in spans] == ["outer", "inner"]
    o, i = spans
    assert (o.parent, o.root, o.request, o.counts) == (None, o.id, 9, {"rows": 3})
    assert (i.parent, i.root, i.request, i.counts) == (o.id, o.id, 9, {"hits": 7})
    assert type(i.counts["hits"]) is int and counters == {"hits": 8}
    assert o.t0 <= i.t0 <= i.t1 <= o.t1 and o.t_twin is i.t_twin is None
    assert tracing.take() == ([], {})


@pytest.mark.parametrize("case", ["generate", "moe_prefill", "train_step"])
def test_results_bit_identical_with_the_recorder_on_and_off(case):
    """The same tokens, MoE logits and trained parameters whether the
    recorder is on or off; off, nothing is recorded."""
    def run():
        if case == "generate":
            return [torch.from_numpy(generate(tiny()))]
        if case == "moe_prefill":
            cfg = tiny("granite_moe_3b", n_experts=8, n_experts_active=2, moe_group=8,
                       capacity_factor=0.5)
            model = get_model(cfg, CPU)
            logits, cache = model.prefill(model.init(0),
                                          make_batch(cfg, ShapeConfig("t", 16, 2, "prefill")))
            return [logits] + [t for _p, t in flatten_with_path(cache)]
        state, losses = train_steps(tiny())
        return [torch.tensor(losses)] + [t for _p, t in flatten_with_path(state)]
    off = run()
    assert tracing.take() == ([], {})
    tracing.enable()
    on = run()
    tracing.disable()
    spans, _counters = tracing.take()
    assert spans
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_preempted_generate_nests_down_to_the_nvm_and_the_crc():
    cfg = tiny()
    tracing.enable()
    out = generate(cfg, crash_at=3, seq_id=5, tokens=8)
    spans, _counters = tracing.take()
    ids = by_id(spans)
    gen = [s for s in spans if s.name == "serve.generate"]
    assert len(gen) == 1 and gen[0].request == 5
    assert gen[0].counts == {"batch": 1, "prompt_len": 8, "tokens": 8}
    assert all(s.root == gen[0].id and s.request == 5 for s in spans)
    chains = {tuple(reversed(ancestry(s, ids))) for s in spans}
    assert ("serve.generate", "serve.snapshot", "pages.snapshot", "erda.multi_write",
            "nvm.write", "nvm.account") in chains
    assert ("serve.generate", "serve.snapshot", "pages.snapshot", "pages.serialize") in chains
    assert ("serve.generate", "serve.resume", "pages.restore", "erda.multi_read",
            "erda.verify", "verify.crc") in chains
    assert ("serve.generate", "serve.resume", "pages.restore", "pages.upload") in chains
    for parent, child in (("serve.decode", "decode.cache_update"),
                          ("serve.decode", "decode.attention"),
                          ("serve.decode", "decode.stack")):
        assert ("serve.generate", parent, child) in chains
    # snapshots at steps 0, 2, 4 and 6; the crash at step 3 resumes from
    # step 2's and recomputes one step: 8 decode steps for 7 new tokens
    resume = next(s for s in spans if s.name == "serve.resume")
    assert resume.counts == {"recomputed": 1}
    names = [s.name for s in spans]
    assert names.count("serve.decode") == names.count("serve.token") == 8
    assert names.count("serve.snapshot") == 4
    assert names.count("decode.cache_update") == names.count("decode.attention") \
        == cfg.n_layers * 8
    restore = next(s for s in spans if s.name == "pages.restore")
    snapshot = next(s for s in spans if s.name == "pages.snapshot")
    assert restore.counts["bytes"] == snapshot.counts["bytes"] > 0
    verify = [s for s in spans if s.name == "erda.verify" and s.counts.get("rows")]
    assert verify and all(s.counts["bytes"] >= 4 * s.counts["rows"] for s in verify)
    assert out.shape == (1, 8)


def test_moe_counters_equal_a_recount_of_the_routing():
    cfg = tiny("granite_moe_3b", n_experts=8, n_experts_active=2, moe_group=8,
               capacity_factor=0.5)
    model = get_model(cfg, CPU)
    params = model.init(0)
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    lp = params["layers"][0]["moe"]
    r = M.route(lp, x, cfg)
    want_pairs, want_dropped = r.keep.numel(), int((~r.keep).sum())
    assert 0 < want_dropped < want_pairs       # this capacity drops pairs
    tracing.enable()
    with tracing.span("serve.prefill"):
        M.apply_moe(lp, x, cfg)
        M.apply_moe(lp, x, cfg)
    spans, counters = tracing.take()
    assert counters == {"moe.pairs": 2 * want_pairs, "moe.dropped": 2 * want_dropped}
    prefill = next(s for s in spans if s.name == "serve.prefill")
    assert prefill.counts == counters
    assert [s.name for s in spans if s.parent == prefill.id] == [
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"] * 2


def test_train_grads_and_update_lie_inside_their_step():
    tracing.enable()
    train_steps(tiny(), n=2)
    spans, _counters = tracing.take()
    steps = [s for s in spans if s.name == "train.step"]
    assert [s.request for s in steps] == [0, 1]
    assert all(s.counts == {"tokens": 32} for s in steps)
    for step in steps:
        kids = [s for s in spans if s.parent == step.id]
        assert [s.name for s in kids] == ["train.grads", "train.update"]
        assert all(step.t0 <= k.t0 <= k.t1 <= step.t1 for k in kids)
        assert kids[0].t1 <= kids[1].t0


@pytest.mark.parametrize("seed", [0, 1])
def test_store_counters_equal_the_reference_with_the_recorder_on(seed):
    """``NVMStats`` and the client's ``stats`` keep no key of the recorder's
    and count what the JAX package's do, spans or not."""
    from tests.test_torch_store_parity import CFG, assert_same_state, op_sequence, run
    keys, ops = op_sequence(seed, n_ops=80)
    ref = r_make_store("erda", cfg=RConfig(**CFG))
    port = t_make_store("erda", cfg=TConfig(**CFG), device="cpu")
    r_obs = run(ref, keys, ops)
    tracing.enable()
    t_obs = run(port, keys, ops)
    spans, counters = tracing.take()
    assert t_obs == r_obs and counters == {}
    assert_same_state(ref, port)
    names = {s.name for s in spans}
    assert {"nvm.write", "nvm.account", "nvm.read", "erda.multi_read", "erda.verify",
            "erda.multi_write", "erda.pack"} <= names
    fallbacks = sum(s.counts.get("fallbacks", 0) for s in spans if s.name == "erda.multi_read")
    assert 0 <= fallbacks <= port.stats["fallbacks"]


def test_spans_open_profiler_twins_while_a_session_is_open():
    from torch.profiler import ProfilerActivity, profile
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer.twin"):
            with tracing.span("inner.twin"):
                torch.ones(4).sum()
    spans, _counters = tracing.take()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("outer.twin") == names.count("inner.twin") == 1
    assert [s.name for s in spans] == ["outer.twin", "inner.twin"]
    assert all(s.t_twin is not None and s.t_twin <= s.t0 for s in spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.disable()
        with tracing.span("unseen"):
            pass
    assert "unseen" not in [e.name() for e in prof.profiler.kineto_results.events()]
