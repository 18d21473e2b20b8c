"""A benchmark tree at CPU size: the real harness's files copied into a
temporary root, with small configurations, mixes, limits and a
``BENCHMARK.json`` naming them, so that a test drives the rest of a run
(``run.execute``) on the CPU, found by name as the card's cells are."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

#: head_dim 32: the flash kernel's smallest (``kernels.flash_attention.HEAD_DIMS``)
OLMO_TINY = {"name": "olmo_tiny", "family": "dense", "n_layers": 2, "d_model": 128,
             "n_heads": 4, "n_kv_heads": 4, "head_dim": 32, "d_ff": 256,
             "vocab_size": 256, "norm": "nonparam_ln", "rope_theta": 10000.0,
             "dtype": "bfloat16"}
GRANITE_TINY = {"name": "granite_tiny", "family": "moe", "n_layers": 2, "d_model": 128,
                "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 64,
                "vocab_size": 256, "n_experts": 8, "n_experts_active": 2,
                "capacity_factor": 1.25, "moe_group": 16, "norm": "rmsnorm",
                "rope_theta": 10000.0, "dtype": "bfloat16"}
MIXES = {
    "tiny_preempt": {"driver": "serve", "batch": 2, "prompt_len": 16, "output_len": 64,
                     "snapshot_every": 32,
                     "preempt": {"steps": [1, 62], "exclude": [1, 30, 33, 62]},
                     "check_requests": 2},
    "tiny_chat": {"driver": "serve", "batch": 3, "prompt_len": 16, "output_len": 8,
                  "check_requests": 3},
    "tiny_long_prompt": {"driver": "serve", "batch": 2, "prompt_len": 64, "output_len": 4,
                         "check_requests": 4},
    "tiny_train": {"driver": "train", "batch": 2, "seq_len": 32,
                   "adamw": {"lr": 3e-4}},
}
#: limits at CPU size, set as the cells' are: above what the program read
#: on seeds 1-3 (logit gap <= 0.0016; loss 1.2e-4, grad 1.6e-3, change
#: 0.074) and under what the control read there (logit gap >= 0.025; grad
#: >= 0.013) or a state left unchanged (change 1; an update without its
#: bias correction 0.50, one 1.5 times too long 0.83).  granite_tiny's widest
#: gap swings with routing near-ties at 8 experts (0.20 on one seed of
#: three at head_dim 16), so its limit only bounds a run that breaks
CELLS = {"olmo_tiny.tiny_preempt": ("olmo_tiny", {"logit_gap": 0.01, "page_diff": 0,
                                                  "crc_diff": 0}),
         "olmo_tiny.tiny_chat": ("olmo_tiny", {"logit_gap": 0.01}),
         "granite_tiny.tiny_long_prompt": ("granite_tiny", {"logit_gap": 1.0}),
         "olmo_tiny.tiny_train": ("olmo_tiny", {"loss_gap": 1e-3, "grad_gap": 0.005,
                                                "change_gap": 0.2})}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_tiny_root(tmp: Path) -> Path:
    shutil.copytree(HERE, tmp / "erdabench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = []
    for m in (OLMO_TINY, GRANITE_TINY):
        write(tmp / "erdabench" / "configs" / f"{m['name']}.json",
              {"name": m["name"], "model": m})
        bench["configs"].append({"name": m["name"], "source": "tests",
                                 "file": f"erdabench/configs/{m['name']}.json",
                                 "reduced": [], "why": "CPU size"})
    for name, mix in MIXES.items():
        write(tmp / "erdabench" / "mixes" / f"{name}.json", mix)
    bench["workloads"] = []
    for cell, (config, limits) in CELLS.items():
        write(tmp / "erdabench" / "limits" / f"{cell}.json", limits)
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": cell.split(".")[1], "chips": 1, "why": "CPU"})
    # every metric in every tiny cell of its driver
    serve = [c for c in CELLS if "train" not in c]
    train = [c for c in CELLS if "train" in c]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = train if any("train" in w for w in m["workloads"]) else serve
    write(tmp / "BENCHMARK.json", bench)
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
