"""A model family's weights, plain reference and FLOP counts are found by
the family's name (``cell.family_module``): the transformer's families
(``dense``, ``moe``) keep the harness's own code and counts, and a module
placed in ``erdabench/families/`` is used by serving, training and both MFU
readers with no other harness file edited, here for the program's
``hybrid`` family, whose cache holds Mamba2 state beside its KV cache and a
``None`` where it has no ssm tail."""
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from erdabench import cell as cells
from erdabench import control, counts, run, serve, train, weights
from erdabench.reference import model as ref_model

from conftest import write
from test_bench_faults import altered_token

CPU = torch.device("cpu")
DOUBLE = Path(__file__).resolve().parent / "family_double.py"

#: zamba2's layout at CPU size: 2 Mamba2 layers and the shared block after
#: them, so no ssm tail (the cache's ``ssm_tail`` is None); float32, so that
#: three steps move the norm scales, which bfloat16 holds at 1
HYBRID_TINY = {"name": "hybrid_tiny", "family": "hybrid", "n_layers": 2, "d_model": 64,
               "n_heads": 2, "n_kv_heads": 2, "head_dim": 32, "d_ff": 128,
               "vocab_size": 256, "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 32,
               "ssm_chunk": 16, "shared_attn_every": 2, "norm": "rmsnorm",
               "rope_theta": 10000.0, "dtype": "float32", "remat": "none"}
#: limits at CPU size, above what the program read against the double's
#: reference (its own forward in float32) on seeds 1-3 (logit gap 0; loss
#: 1.7e-7, grad 3.9e-7, change 2.8e-6) and under a planted fault's reading
#: (``test_hybrid_fault_is_not_correct``)
HYBRID_CELLS = {"hybrid_tiny.tiny_preempt": {"logit_gap": 0.01, "page_diff": 0, "crc_diff": 0},
                "hybrid_tiny.tiny_train": {"loss_gap": 1e-3, "grad_gap": 1e-3,
                                           "change_gap": 1e-3}}


def add_hybrid(root: Path) -> Path:
    """The double as ``erdabench/families/hybrid.py``, the tiny hybrid
    configuration and its two cells, in every metric of their driver."""
    (root / "erdabench" / "families").mkdir()
    shutil.copy(DOUBLE, root / "erdabench" / "families" / "hybrid.py")
    write(root / "erdabench" / "configs" / "hybrid_tiny.json",
          {"name": "hybrid_tiny", "model": HYBRID_TINY})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hybrid_tiny", "source": "tests", "reduced": [],
                             "file": "erdabench/configs/hybrid_tiny.json", "why": "CPU size"})
    for cell, limits in HYBRID_CELLS.items():
        write(root / "erdabench" / "limits" / f"{cell}.json", limits)
        bench["workloads"].append({"name": cell, "config": "hybrid_tiny", "chips": 1,
                                   "traffic": cell.split(".")[1], "why": "CPU"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "olmo_tiny.tiny_preempt" in m.get("workloads", []):
            m["workloads"].append("hybrid_tiny.tiny_preempt")
        if "olmo_tiny.tiny_train" in m.get("workloads", []):
            m["workloads"].append("hybrid_tiny.tiny_train")
    write(root / "BENCHMARK.json", bench)
    return root


@pytest.mark.parametrize("w", ["olmo_tiny.tiny_chat", "granite_tiny.tiny_long_prompt"])
def test_transformer_families_keep_todays_code(tiny_root, w):
    c = cells.load(w, tiny_root)
    assert c.model["family"] in ("dense", "moe") and cells.own_family(c.model) is None
    fam = cells.family_module(c.model)
    assert fam.make_params is weights.make_params
    assert fam.Reference is ref_model.Reference
    assert fam.served_logits is ref_model.served_logits
    assert fam.prefill_flops is counts.prefill_flops
    assert fam.train_flops is counts.train_flops


#: the parent's counts at the cells' shapes, to the operation
@pytest.mark.parametrize("w,count,batch,seq,want", [
    ("olmo_1b.chat", "prefill_flops", 32, 512, 35740721348608),
    ("olmo_1b.preempt", "prefill_flops", 2, 256, 1108513652736),
    ("olmo_1b.train", "train_flops", 8, 2048, 128874788683776),
    ("granite_moe_3b.long_prompt", "prefill_flops", 4, 3840, 30598219468800),
    ("granite_moe_3b.long_prompt", "train_flops", 8, 2048, 106571476500480),
])
def test_transformer_counts_unchanged(w, count, batch, seq, want):
    assert getattr(counts, count)(cells.load(w).model, batch, seq) == want


def test_family_module_must_define_the_api(tmp_path):
    (tmp_path / "erdabench" / "families").mkdir(parents=True)
    (tmp_path / "erdabench" / "families" / "partial.py").write_text(
        "def make_params(m, seed, device):\n    return {}\n")
    m = cells.Model({"family": "partial"}, tmp_path)
    with pytest.raises(AttributeError, match="Reference, served_logits"):
        cells.family_module(m)


def spy(monkeypatch, module):
    """Keep what ``module.run`` returns to ``run.execute``."""
    kept, real = {}, module.run

    def keep(*args, **kwargs):
        kept.update(real(*args, **kwargs))
        return kept
    monkeypatch.setattr(module, "run", keep)
    return kept


@pytest.fixture
def hybrid_root(tiny_root):
    return add_hybrid(tiny_root)


def test_hybrid_family_serves_and_resumes(hybrid_root, monkeypatch):
    """A preempted hybrid batch snapshots Mamba2 ``conv`` and ``h`` state
    beside the shared block's KV and resumes bit for bit, judged by the
    family's reference; ``prefill_mfu`` reads the family's count."""
    c = cells.load("hybrid_tiny.tiny_preempt", hybrid_root)
    double = cells.family_module(c.model)
    assert double is cells.own_family(c.model) and double.make_params is not weights.make_params
    del double.CALLS[:]
    out = spy(monkeypatch, serve)
    r = run.execute(c, 2**31 + 91, 0.3, False, CPU, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["checks"]["page_diff"]["value"] == 0 and r["checks"]["crc_diff"]["value"] == 0
    assert r["info"]["resumes"] > 0 and r["info"]["crc_rows"] > 0
    names = {name for _seq, name in out["runner"].rec.put.pages}
    for leaf in ("['ssm_main']['conv']", "['ssm_main']['h']", "['attn']['k']", "['attn']['v']"):
        assert leaf in names
    assert not any("ssm_tail" in n for n in names)
    called = [call[0] for call in double.CALLS]
    assert called == ["make_params", "Reference", "served_logits"]
    reading = out["reading"]
    assert reading.model is c.model
    mfu = cells.reader("prefill_mfu", hybrid_root)(reading)
    B, P = c.mix["batch"], c.mix["prompt_len"]
    assert double.CALLS[-1] == ("prefill_flops", B, P)
    assert counts.prefill_flops(c.model, B, P) == double.prefill_flops(c.model, B, P)
    assert mfu == pytest.approx(100 * reading.count("prefill") * double.prefill_flops(c.model, B, P)
                                / reading.seconds("prefill") / counts.BF16_TENSOR_OPS_PER_S)


def test_hybrid_family_trains(hybrid_root, monkeypatch):
    """The train step's first three steps are judged by the family's
    reference, from the family's weights; ``train_mfu`` reads the family's
    count."""
    c = cells.load("hybrid_tiny.tiny_train", hybrid_root)
    double = cells.family_module(c.model)
    del double.CALLS[:]
    out = spy(monkeypatch, train)
    r = run.execute(c, 2**31 + 91, 0.3, False, CPU, time.perf_counter())
    assert r["correct"], r["checks"]
    seed = 2**31 + 91
    B, S = c.mix["batch"], c.mix["seq_len"]
    assert double.CALLS == [("make_params", seed), ("Reference", "fp32"), ("make_params", seed),
                            ("loss", (B, S)), ("loss", (B, S)), ("loss", (B, S))]
    mfu = cells.reader("train_mfu", hybrid_root)(out["reading"])
    flops = double.train_flops(c.model, B, S)
    assert counts.train_flops(c.model, B, S) == flops
    reading = out["reading"]
    assert mfu == pytest.approx(100 * reading.count("step") * flops / reading.seconds("step")
                                / counts.BF16_TENSOR_OPS_PER_S)


@pytest.mark.parametrize("w,fault", [
    ("hybrid_tiny.tiny_preempt", {"wrap_model": altered_token}),
    ("hybrid_tiny.tiny_train", {"wrap_step": control.unchanged_state}),
])
def test_hybrid_fault_is_not_correct(hybrid_root, w, fault):
    """The family's reference judges: a token altered where it is produced,
    or a train step that returns its state unchanged, is not correct."""
    r = run.execute(cells.load(w, hybrid_root), 5, 0.3, False, CPU, time.perf_counter(),
                    **fault)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("w", list(HYBRID_CELLS))
def test_hybrid_cell_on_the_card(hybrid_root, card, w, trace):
    r = run.execute(cells.load(w, hybrid_root), 13, 1.0, bool(trace), card, time.perf_counter())
    assert r["correct"], r["checks"]
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"] and r["metrics"]
