"""On the card, at test size: every driver runs a cell through the kernels
and judges it correct, the traced run reads its device metrics, and the
control fails where the program passes.  Skips without a card.

    python -m pytest -q -m cuda erdabench/tests/test_bench_card.py
"""
import time

import pytest

from erdabench import cell as cells
from erdabench import run, serve

pytestmark = pytest.mark.cuda

CELLS = ["olmo_tiny.tiny_preempt", "olmo_tiny.tiny_chat",
         "granite_tiny.tiny_long_prompt", "olmo_tiny.tiny_train"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("w", CELLS)
def test_cell_on_the_card(tiny_root, card, w, trace):
    r = run.execute(cells.load(w, tiny_root), 11, 1.0, bool(trace), card, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert r["breakdown"]["device_ops"] and r["metrics"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_serve_control_fails_on_the_card(tiny_root, card, seed):
    c = cells.load("olmo_tiny.tiny_chat", tiny_root)
    out = serve.run(c, seed, 0.5, False, card, time.perf_counter())
    prompts, served = out["runner"].sample()
    assert out["runner"].logit_gaps(prompts, served, "fp8")["logit_gap"] > c.limits["logit_gap"]
