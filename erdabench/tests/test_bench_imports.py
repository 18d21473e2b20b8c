"""No run of the benchmark loads JAX, the JAX package ``repro`` or its
``benchmarks/``, compared by whole top-level module names (``repro_torch``
begins with ``repro``), and the plain reference and every family module
(``erdabench/families/``) import nothing of the program."""
import json
import shutil
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


#: top-level modules a family module may not bring in: the program, JAX, its
#: libraries, the JAX package and its benchmark
NOT_IN_A_FAMILY = ("repro_torch",) + run.FORBIDDEN

FAMILY = """
import importlib.util, json, sys
from pathlib import Path
root, path = Path(sys.argv[1]), Path(sys.argv[2])
sys.path[:0] = [str(root), {src!r}]
spec = importlib.util.spec_from_file_location("family_under_test", path)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}} & set({names!r}))))
""".format(src=str(ROOT / "src"), names=NOT_IN_A_FAMILY)


def family_imports(root: Path) -> dict:
    """Each file of ``root``'s ``erdabench/families/`` -> the forbidden
    top-level modules that loading it, alone in a fresh process with the
    program importable, brings in."""
    out = {}
    for path in sorted((root / "erdabench" / "families").glob("*.py")):
        got = subprocess.run([sys.executable, "-c", FAMILY, str(root), str(path)],
                             capture_output=True, text=True, timeout=300, cwd=root)
        assert got.returncode == 0, got.stderr[-3000:]
        out[path.name] = json.loads(got.stdout.strip().splitlines()[-1])
    return out


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


def test_family_modules_import_nothing_of_the_program():
    """Every family module of this tree, as the reference."""
    found = family_imports(ROOT)
    assert found == {name: [] for name in found}


def test_family_guard_catches_a_planted_import(tmp_path):
    """In a copy of the tree, a family module that imports the program is
    caught, one that imports the harness's weights and reference is not."""
    families = tmp_path / "erdabench" / "families"
    shutil.copytree(ROOT / "erdabench", tmp_path / "erdabench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    families.mkdir(exist_ok=True)
    (families / "clean.py").write_text(
        "from erdabench import weights\nfrom erdabench.reference import model\n")
    (families / "planted.py").write_text(
        "from erdabench import weights\nimport repro_torch\n")
    found = family_imports(tmp_path)
    assert found["clean.py"] == [] and found["planted.py"] == ["repro_torch"]


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
