"""The traced slice's arithmetic and the per-layer readers on made-up
spans and device intervals (a CPU run has no device trace)."""
import pytest

from erdabench import cell as cells
from erdabench.reading import Reading
from erdabench.trace import Profile

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256}


def profile():
    # device busy 0-1, 2-2.5 (two overlapping kernels), 4-5; window 0-6
    kernels = [("gemm", 0.0, 1.0), ("flash_fwd_wgmma_kernel<64>", 2.0, 2.4),
               ("copy", 2.2, 2.5), ("crc32_chunks_kernel", 4.0, 4.75),
               ("crc32_rows_kernel", 4.75, 5.0)]
    return Profile(kernels, (0.0, 6.0))


def test_busy_and_gaps():
    p = profile()
    assert p.busy_s() == pytest.approx(2.5)
    assert p.busy_s([(0.5, 2.25)]) == pytest.approx(0.75)
    gaps = p.idle_gaps([("prefill", 0.0, 3.0), ("decode", 3.0, 6.0)])
    assert [g[0] for g in gaps] == ["decode", "prefill", "decode"]
    assert [round(g[1], 6) for g in gaps] == [1.5, 1.0, 1.0]
    assert p.device_s("crc32_") == pytest.approx(1.0)


def reading():
    r = Reading(model=MODEL, mix={"batch": 2, "prompt_len": 8, "seq_len": 8})
    r.profile = profile()
    r.traced_segments = [("prefill", 0.0, 3.0), ("decode", 3.0, 6.0)]
    r.segments = [("prefill", 10.0, 10.5), ("decode", 10.5, 10.52), ("decode", 10.52, 10.56)]
    r.calls = [("snapshot_cache", 0.0, 2.0, 200_000_000), ("restore_cache", 3.0, 3.5, 100_000_000)]
    r.counters = {"flash_shapes": {(8, 8, 16, "bfloat16"): 2}, "crc_shapes": {(3, 1000): 1},
                  "nvm_bytes": 1010, "page_bytes": 1000}
    return r


@pytest.mark.parametrize("name,want", [
    ("decode_step_ms", 30.0),
    ("device_idle_share.prefill", 100 * (1 - 1.5 / 3)),
    ("device_idle_share.decode", 100 * (1 - 1.0 / 3)),
    ("snapshot_mb_per_s", 100.0),
    ("restore_mb_per_s", 200.0),
    ("nvm_bytes_per_page_byte", 1.01),
])
def test_reader(name, want):
    assert cells.reader(name)(reading()) == pytest.approx(want)


def test_roofline_readers():
    from erdabench import counts
    r = reading()
    flash = cells.reader("flash_roofline")(r)
    assert flash == pytest.approx(100 * 2 * counts.flash_bound_ms(8, 8, 16, "bfloat16")[0]
                                  / 1e3 / 0.4)
    crc = cells.reader("crc_roofline")(r)
    assert crc == pytest.approx(100 * counts.crc_bound_ms(3, 1000)[0] / 1e3 / 1.0)
    mfu = cells.reader("prefill_mfu")(r)
    assert mfu == pytest.approx(100 * counts.prefill_flops(MODEL, 2, 8) / 0.5
                                / counts.BF16_TENSOR_OPS_PER_S)


def test_readers_find_nothing_without_a_trace():
    r = Reading(model=MODEL, mix={"batch": 2, "prompt_len": 8})
    for name in ("flash_roofline", "crc_roofline", "device_idle_share.decode",
                 "decode_step_ms", "snapshot_mb_per_s", "prefill_mfu", "resume_wait_ms"):
        assert cells.reader(name)(r) is None


def test_resume_wait_reader():
    """Each resume runs from the call into restore_cache to the end of the
    get_page after it (the tokens page); a get_page with no restore before
    it is no resume."""
    r = reading()
    r.calls = [("get_page", 0.0, 0.1, 8), ("snapshot_cache", 0.1, 0.3, 100),
               ("restore_cache", 1.0, 1.3, 100), ("get_page", 1.3, 1.35, 8),
               ("decode_step", 1.35, 1.4, 0), ("restore_cache", 2.0, 2.2, 100),
               ("get_page", 2.2, 2.3, 8)]
    assert cells.reader("resume_wait_ms")(r) == pytest.approx(1e3 * (0.35 + 0.3) / 2)


def test_resume_wait_reads_the_runs_resumes(tiny_root):
    """On a preempted tiny cell the reader gives the mean of the resumes the
    serving driver itself times, restore to tokens page."""
    import time

    import torch

    from erdabench import serve
    out = serve.run(cells.load("olmo_tiny.tiny_preempt", tiny_root), 3, 0.3, False,
                    torch.device("cpu"), time.perf_counter())
    resumes = out["runner"].rec.resumes
    assert len(resumes) >= 2
    got = cells.reader("resume_wait_ms")(out["reading"])
    assert got == pytest.approx(1e3 * sum(resumes) / len(resumes), abs=1.0)
