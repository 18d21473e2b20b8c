"""No run of the benchmark loads JAX, the JAX package ``repro`` or its
``benchmarks/``, compared by whole top-level module names (``repro_torch``
begins with ``repro``), and the plain reference imports nothing of the
program."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from erdabench import run

ROOT = Path(__file__).resolve().parents[2]
TESTS = Path(__file__).resolve().parent

RUN_CELLS = f"""
import json, sys, tempfile, time
from pathlib import Path
sys.path[:0] = [{str(ROOT)!r}, {str(TESTS)!r}]
from erdabench import run
run.prepare_environment()
import torch
from conftest import make_tiny_root
from erdabench import cell
root = make_tiny_root(Path(tempfile.mkdtemp()))
for w in ("olmo_tiny.tiny_preempt", "granite_tiny.tiny_long_prompt", "olmo_tiny.tiny_train"):
    run.execute(cell.load(w, root), 5, 0.2, False, torch.device("cpu"), time.perf_counter())
bench = str(Path({str(ROOT)!r}) / "benchmarks")
files = [m for m, mod in list(sys.modules.items())
         if str(getattr(mod, "__file__", None) or "").startswith(bench)]
print(json.dumps({{"forbidden": run.forbidden_modules(), "from_benchmarks": files,
                  "port": "repro_torch" in sys.modules}}))
"""

REFERENCE = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
import erdabench.reference.model, erdabench.reference.adamw, erdabench.reference.pages
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("repro_torch", "repro", "jax")
                        or (m.startswith("erdabench.") and not m.startswith("erdabench.reference")))))
"""


def python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_runs_load_no_jax_and_no_repro():
    got = python(RUN_CELLS)
    assert got["port"], "the cells did not run the port"
    assert got["forbidden"] == [] and got["from_benchmarks"] == []


def test_reference_imports_nothing_of_the_program():
    assert python(REFERENCE) == []


@pytest.mark.parametrize("mods,found", [
    (["repro_torch", "repro_torch.core"], []),
    (["repro", "repro_torchx"], ["repro"]),
    (["repro.core.api", "jax.numpy", "jaxlib", "flax", "benchmarks.run"],
     ["benchmarks.run", "flax", "jax.numpy", "jaxlib", "repro.core.api"]),
])
def test_forbidden_compares_whole_names(monkeypatch, mods, found):
    fake = {m: object() for m in mods}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == found
