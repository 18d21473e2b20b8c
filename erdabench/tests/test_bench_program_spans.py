"""The program's spans on the profiler's clock (``erdabench.program_spans``)
and the per-layer readers that take them, on made-up events and spans (a
CPU run has no device trace)."""
import pytest

from erdabench import cell as cells
from erdabench import program_spans as ps
from erdabench.reading import Reading
from erdabench.trace import ANCHOR, MARK_KERNEL
from repro_torch.tracing import SpanRecord

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256}
T_ANCHOR = 100.0    # perf_counter second of the anchor, at profiler us 1000


def span(name, t0, t1, sid=0, parent=None, t_twin=None, **counts):
    return SpanRecord(name, sid, parent, sid if parent is None else parent, None,
                      t0, t1, counts, t_twin)


def us(t):
    """The profiler's microsecond of host second ``t`` on the anchor's map."""
    return 1000.0 + (t - T_ANCHOR) * 1e6


def events(kernels, twins=(), clock=lambda t: t):
    """Session events: the anchor, the two markers at 100.0 and 100.9 s,
    each (name, launch s or None, start s, end s) kernel with its runtime
    call unless its launch is None, a user annotation on the device, and
    (name, start s) record_function twins on the host; ``clock`` maps each
    host second to the second the profiler's clock reads then."""
    at = lambda t: us(clock(t))
    out = [(ANCHOR, False, at(T_ANCHOR), at(T_ANCHOR) + 1, 0, True),
           ("void spin_kernel", True, at(100.0), at(100.001), 1, False),
           ("void spin_kernel", True, at(100.899), at(100.9), 2, False),
           ("serve.decode", True, at(100.1), at(100.6), 3, True)]
    for corr, (name, launch, a, b) in enumerate(kernels, start=10):
        out.append((name, True, at(a), at(b), corr, False))
        if launch is not None:
            out.append(("cudaLaunchKernel", False, at(launch), at(launch) + 5, corr, False))
    out += [(name, False, at(t), at(t) + 3, 0, True) for name, t in twins]
    return out


SPANS = [span("serve.decode", 100.05, 100.20, 1),
         span("decode.cache_update", 100.06, 100.08, 2, 1),
         span("decode.stack", 100.15, 100.18, 3, 1),
         span("serve.token", 100.20, 100.7, 4)]
#: copies launched inside cache_update and stack, a gemm inside decode, an
#: argmax inside token, and a kernel with no runtime call that started
#: (hence was launched) inside decode
KERNELS = [("index_copy", 100.07, 100.30, 100.34),
           ("gemm", 100.10, 100.34, 100.44),
           ("cat", 100.16, 100.44, 100.46),
           ("argmax", 100.21, 100.46, 100.47),
           ("ctypes_kernel", None, 100.185, 100.195)]


def profile(spans=SPANS, twins=()):
    return ps.build_profile(events(KERNELS, twins), T_ANCHOR, spans)


def test_operations_are_attributed_to_the_span_that_launched_them():
    p = profile()
    assert [k[0] for k in p.kernels] == [k[0] for k in KERNELS]     # no annotation, no marker
    assert p.launches[:4] == pytest.approx([k[1] for k in KERNELS[:4]])
    assert p.launches[4] is None
    assert p.device_s_launched_in(SPANS, ("decode.cache_update",)) == pytest.approx(0.04)
    assert p.device_s_launched_in(SPANS, ("decode.cache_update", "decode.stack")) \
        == pytest.approx(0.06)
    # the ctypes kernel counts by its device start, 100.185, inside decode
    assert p.device_s_launched_in(SPANS, ("serve.decode",)) == pytest.approx(0.17)
    assert p.device_s_launched_in(SPANS, ("serve.token",)) == pytest.approx(0.01)
    assert p.unattributed_device_share() == pytest.approx(0.01 / 0.18)
    assert p.window == pytest.approx((100.0, 100.9))


def test_a_trace_that_lost_a_marker_gives_no_profile():
    evs = [e for e in events(KERNELS) if not (MARK_KERNEL in e[0] and e[4] == 2)]
    assert ps.build_profile(evs, T_ANCHOR, SPANS) is None


def test_clock_skew_on_the_anchor_and_its_least_squares_fallback():
    twins = [(s.name, s.t0 - 5e-6) for s in SPANS]
    p = profile(twins=twins)
    assert p.clock_fit == "anchor" and p.clock_skew_us == pytest.approx(5.0, abs=1e-3)
    # a profiler clock 1 % fast drifts 2 ms off the anchor's map by 100.2 s
    drift = lambda t: T_ANCHOR + (t - T_ANCHOR) * 1.01
    p = ps.build_profile(events(KERNELS, twins=twins, clock=drift), T_ANCHOR, SPANS)
    assert p.clock_fit == "least_squares" and p.clock_skew_us < 1.0
    # the line maps each kernel back to its host second, within the twins' 5 us
    assert [k[1] for k in p.kernels] == pytest.approx([k[2] for k in KERNELS], abs=1e-5)


def test_clock_report_places_the_twins_and_the_runtime_calls():
    twins = [(s.name, s.t0 - 5e-6) for s in SPANS]
    evs = events(KERNELS, twins)
    rep = ps.clock_report(evs, SPANS, ps.build_profile(evs, T_ANCHOR, SPANS))
    assert rep["twins"] == 4 and rep["gap_us"] == pytest.approx([5.0] * 4, abs=1e-3)
    assert rep["line_ppm"] == pytest.approx(0.0, abs=1e-6)
    # the first runtime call after decode's twin is index_copy's launch at 100.07
    assert rep["runtime_lag_us"][1] >= rep["runtime_lag_us"][0] > 0
    assert {w[0] for w in rep["gap_worst"]} == {s.name for s in SPANS}
    assert ps.clock_report(events(KERNELS), SPANS, profile()) == {}


def test_twins_are_matched_by_name_in_order():
    twins = [("serve.decode", 100.05), ("decode.stack", 100.15)]
    pairs = ps.twin_pairs(events(KERNELS, twins=twins), SPANS)
    assert sorted(t for _us, _lo, t in pairs) == [100.05, 100.15]
    extra = ps.twin_pairs(events(KERNELS, twins=twins + [("decode.stack", 100.3)]), SPANS)
    assert sorted(t for _us, _lo, t in extra) == [100.05]        # counts differ: left out
    assert ps.fit_line([(0, 1), (1, 3), (2, 5)]) == pytest.approx((2.0, 1.0))


def test_a_twin_inside_the_seconds_it_opened_in_is_no_skew():
    """A host stall while a twin opens puts the span's start well after
    the twin's; the twin still lies between ``t_twin`` and the start."""
    stalled = [span("serve.decode", 100.05, 100.20, 1, t_twin=100.048),
               span("serve.token", 100.20, 100.7, 4, t_twin=100.1999)]
    evs = events(KERNELS, twins=[("serve.decode", 100.0485), ("serve.token", 100.19995)])
    p = ps.build_profile(evs, T_ANCHOR, stalled)
    assert p.clock_fit == "anchor" and p.clock_skew_us == pytest.approx(0.0, abs=1e-3)
    assert ps.off_by(3.0, 1.0, 2.0) == 1.0 and ps.off_by(0.5, 1.0, 2.0) == -0.5
    assert ps.off_by(1.5, 1.0, 2.0) == 0.0


def test_idle_by_span_splits_each_gap_over_the_spans_it_crosses():
    # busy 100.185-100.195 and 100.30-100.47 (the markers are left out of
    # the kernels); idle 100.0-100.185: none, decode, cache_update, decode,
    # stack, decode; 100.195-100.30: decode, token; 100.47-100.9: token, none
    idle = dict(map(tuple, profile().idle_by_span(SPANS)))
    assert idle == pytest.approx({
        "between_spans": 0.05 + 0.2, "decode.cache_update": 0.02, "decode.stack": 0.03,
        "serve.decode": 0.01 + 0.07 + 0.005 + 0.005, "serve.token": 0.1 + 0.23})
    assert sum(idle.values()) == pytest.approx(0.9 - 0.18)


def test_device_and_host_seconds_by_span():
    by = dict(map(tuple, profile().device_s_by_span(SPANS)))
    assert by == pytest.approx({"decode.cache_update": 0.04, "serve.decode": 0.11,
                                "decode.stack": 0.02, "serve.token": 0.01})
    top = profile().top_ops_by_span(SPANS, ["serve.decode", "serve.token"])
    assert top == {"serve.decode": [["gemm", pytest.approx(0.10)],
                                    ["ctypes_kernel", pytest.approx(0.01)]],
                   "serve.token": [["argmax", pytest.approx(0.01)]]}
    host = ps.host_s_by_span(SPANS)
    assert host["serve.decode"] == pytest.approx([1, 0.15, 0.15 - 0.02 - 0.03])
    assert host["decode.stack"] == pytest.approx([1, 0.03, 0.03])


def test_innermost_and_inside():
    times, names = ps.innermost(SPANS)
    at = lambda t: ps.name_at((times, names), t)
    assert [at(t) for t in (100.0, 100.07, 100.1, 100.16, 100.19, 100.5, 100.8)] == [
        None, "decode.cache_update", "serve.decode", "decode.stack", "serve.decode",
        "serve.token", None]
    assert ps.seconds_inside(SPANS, ("decode.stack",), ("serve.decode",)) \
        == pytest.approx(0.03)
    assert ps.span_seconds(SPANS, ("serve.decode", "serve.token")) == pytest.approx(0.65)


def reading(**kw):
    r = ps.SpanReading(model=MODEL, mix={"batch": 2, "prompt_len": 8})
    r.profile = profile()
    r.traced_spans = SPANS
    for k, v in kw.items():
        setattr(r, k, v)
    return r


PREFILL = [span("serve.prefill", 100.05, 100.20, 1, **{"moe.pairs": 400, "moe.dropped": 6}),
           span("moe.route", 100.06, 100.08, 2, 1),
           span("moe.dispatch", 100.09, 100.11, 3, 1),
           span("moe.experts", 100.12, 100.15, 4, 1),
           span("moe.combine", 100.155, 100.18, 5, 1),
           span("serve.decode", 100.20, 100.7, 6, **{"moe.pairs": 100, "moe.dropped": 0})]
TRAIN = [span("train.step", 100.05, 100.25, 1), span("train.grads", 100.06, 100.15, 2, 1),
         span("train.update", 100.15, 100.2, 3, 1)]
WINDOW = [span("pages.snapshot", 10.0, 11.0, 1, bytes=100),
          span("nvm.write", 10.2, 10.5, 2, 1), span("nvm.write", 10.6, 10.8, 3, 1),
          span("nvm.write", 12.0, 12.5, 4),                       # outside a snapshot
          span("pages.restore", 13.0, 13.4, 5, bytes=100),
          span("erda.verify", 13.1, 13.2, 6, 5)]


@pytest.mark.parametrize("name,kw,want", [
    ("decode_cache_copy_share", {}, 100 * 0.06 / 0.17),
    ("moe_dispatch_share", {"traced_spans": PREFILL},
     # launches in route (100.07 copy), dispatch (100.10 gemm), combine
     # (100.16 cat), over everything launched inside prefill
     100 * (0.04 + 0.10 + 0.02) / (0.04 + 0.10 + 0.02 + 0.01)),
    ("moe_drop_share", {"traced_spans": PREFILL}, 100 * 6 / 400),
    # cat (100.16) and the ctypes kernel (100.185) inside update, of all 0.18
    ("train_update_share", {"traced_spans": TRAIN}, 100 * 0.03 / 0.18),
    ("snapshot_nvm_share", {"spans": WINDOW}, 50.0),
    ("restore_verify_share", {"spans": WINDOW}, 25.0),
])
def test_span_reader(name, kw, want):
    assert cells.reader(name)(reading(**kw)) == pytest.approx(want)


@pytest.mark.parametrize("name", ps.SPAN_METRICS)
def test_span_readers_find_nothing_without_the_programs_spans(name):
    """None from a plain ``Reading`` (what the harness's own run hands a
    reader), from a reading without spans, and from a profile that keeps
    no launch times."""
    from erdabench.trace import Profile
    plain = Reading(model=MODEL, mix={"batch": 2, "prompt_len": 8})
    plain.profile = Profile([("gemm", 0.0, 1.0)], (0.0, 2.0))
    assert cells.reader(name)(plain) is None
    assert cells.reader(name)(ps.SpanReading(model=MODEL, mix={})) is None
    if name == "moe_dispatch_share":         # a prefill with no MoE layer
        dense = reading(traced_spans=[span("serve.prefill", 100.05, 100.20, 9)])
        assert dense.profile.device_s_launched_in(dense.traced_spans, ("serve.prefill",))
        assert cells.reader(name)(dense) is None
    no_launch = reading(traced_spans=SPANS + PREFILL + TRAIN, spans=[])
    no_launch.profile = plain.profile
    if name in ("decode_cache_copy_share", "moe_dispatch_share", "train_update_share"):
        assert cells.reader(name)(no_launch) is None


def test_twins_beside_their_wrappers():
    r = ps.SpanReading(model=MODEL, mix={})
    r.segments = [("prefill", 0.0, 0.5), ("decode", 0.5, 0.52), ("decode", 0.52, 0.56)]
    r.calls = [("snapshot_cache", 1.0, 2.0, 200), ("restore_cache", 3.0, 3.5, 100)]
    r.spans = [span("serve.prefill", 0.0, 0.4, 1), span("serve.first_token", 0.4, 0.49, 2),
               span("serve.decode", 0.5, 0.51, 3), span("serve.token", 0.51, 0.519, 4),
               span("serve.decode", 0.52, 0.53, 5), span("serve.token", 0.53, 0.559, 6),
               span("pages.snapshot", 1.0, 1.99, 7, bytes=200),
               span("pages.restore", 3.0, 3.49, 8, bytes=100)]
    t = ps.twins(r)
    assert t["decode_step_ms"]["wrapper"] == pytest.approx(30.0)
    assert t["decode_step_ms"]["twin"] == pytest.approx(29.0)
    assert t["prefill_ms"]["gap"] == pytest.approx(0.49 / 0.5 - 1)
    assert t["snapshot_mb_per_s"]["twin"] == pytest.approx(200 / 0.99 / 1e6)
    assert t["restore_mb_per_s"]["wrapper"] == pytest.approx(100 / 0.5 / 1e6)
    assert "train_step_ms" not in t
