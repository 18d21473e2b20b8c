"""The benchmark is driven by data: a cell, a configuration, a mix, a limit
and a per-layer metric are each a file found by name, and BENCHMARK.json
keeps to the contract's shape."""
import json
import re
import time

import pytest
import torch

from erdabench import cell as cells
from erdabench import run
from erdabench.cell import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["erdabench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(w):
    """Each cell finds its configuration, mix and limits by name, reports
    setup_s, another end-to-end metric and a per-layer metric, and every
    per-layer metric it lists has its reader and moves a metric the cell
    reports."""
    c = cells.load(w)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(cells.reader(m["name"]))
    assert c.limits and c.mix["driver"] in ("serve", "train")
    assert {"n_layers", "d_model", "vocab_size"} <= set(c.model)


def test_reduced_is_no_width():
    widths = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|_rank$|expan|per_tok)")
    for c in BENCH["configs"]:
        assert not any(widths.search(k) for k in c["reduced"]), c["reduced"]


def test_new_mix_file_is_found(tiny_root):
    """A mix added as a file in a copy of the tree, with a workload naming
    it, runs without any code changed."""
    mix = json.loads((tiny_root / "erdabench/mixes/tiny_chat.json").read_text())
    mix.update(batch=2, output_len=5)
    (tiny_root / "erdabench/mixes/tiny_chat_short.json").write_text(json.dumps(mix))
    (tiny_root / "erdabench/limits/olmo_tiny.tiny_chat_short.json").write_text(
        json.dumps({"logit_gap": 0.01}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "olmo_tiny.tiny_chat_short", "config": "olmo_tiny",
                               "traffic": "tiny_chat_short", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "olmo_tiny.tiny_chat" in m.get("workloads", []):
            m["workloads"].append("olmo_tiny.tiny_chat_short")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.load("olmo_tiny.tiny_chat_short", tiny_root)
    assert c.mix["output_len"] == 5
    r = run.execute(c, 1, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] and r["attempted"] % 2 == 0
    assert set(r["metrics"]) == {"setup_s", "ttft_p95_ms", "output_tokens_per_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("w", ["olmo_tiny.tiny_preempt", "olmo_tiny.tiny_chat",
                               "granite_tiny.tiny_long_prompt", "olmo_tiny.tiny_train"])
def test_tiny_cell_runs_correct(tiny_root, w):
    """Every driver runs a cell end to end on the CPU and judges it
    correct at a seed its limits were not set from."""
    r = run.execute(cells.load(w, tiny_root), 2**31 + 77, 0.3, False,
                    torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["metrics"]["setup_s"]["value"] > 0
