"""Guards on the port package ``repro_torch``: it imports neither JAX nor the
JAX package, its copies of the protocol modules do not drift from the
reference, and its entry points never fall back to the CPU unasked."""
import ast
import importlib
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}

#: modules copied from repro unchanged apart from the import prefix
VERBATIM = ["nvmsim/device.py", "core/hashtable.py", "core/log.py",
            "core/server.py", "core/recovery.py", "core/cleaning.py",
            "core/replication.py", "core/resharding.py",
            "core/baselines/redo_logging.py",
            "core/baselines/read_after_write.py"]
#: copies the port changes, with the functions it changes; every other
#: top-level function and method must stay the reference's
CHANGED = {
    "core/client.py": {"ErdaClient.__init__", "ErdaClient._parse_object",
                       "ErdaClient.multi_read"},
    "core/api.py": {"ErdaStore.__init__", "ErdaClusterStore.__init__",
                    "make_store"},
    "core/cluster.py": {"ErdaCluster.__init__", "ErdaCluster._connect"},
    "core/layout.py": {"verify_records", "view_record"},
    "fabric/transport.py": {"make_transport"},
}


def port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_repro():
    """In a fresh interpreter: import every module of repro_torch, run a
    store round trip on the CPU, and find no jax / repro in sys.modules."""
    code = f"""
import importlib, sys
for name in {port_modules()!r}:
    importlib.import_module(name)
from repro_torch.core import ServerConfig, make_store
s = make_store("erda-cluster", n_shards=2, replication=2, device="cpu",
               cfg=ServerConfig(device_size=4 << 20, table_capacity=1 << 9,
                                n_heads=2, region_size=256 << 10,
                                segment_size=32 << 10))
s.multi_write([(k, bytes([k]) * k) for k in range(1, 20)])
assert s.multi_read(list(range(1, 20))) == [bytes([k]) * k for k in range(1, 20)]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(root, line) for root, line in imported_roots(path)
           if root in FORBIDDEN_ROOTS]
    assert not bad, f"{path}: {bad}"


def ported_text(rel: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", (SRC / "repro" / rel).read_text())


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match_reference(rel):
    assert (PORT / rel).read_text() == ported_text(rel)


def functions(source: str):
    """qualified name -> AST dump of every top-level function and method."""
    out = {}
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = ast.dump(sub)
    return out


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_copies_drift_only_where_ported(rel):
    ref = functions(ported_text(rel))
    port = functions((PORT / rel).read_text())
    allowed = CHANGED[rel]
    assert allowed <= set(port)
    for name, dump in ref.items():
        if name not in allowed:
            assert port.get(name) == dump, f"{rel}: {name} drifted"
    assert set(port) - set(ref) <= allowed


def test_sim_transport_is_not_ported_yet():
    from repro_torch.fabric import make_transport
    from repro_torch.nvmsim.device import NVMDevice
    with pytest.raises(NotImplementedError, match="not ported"):
        make_transport("sim", NVMDevice(1 << 16))


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.checkpoint import (ErdaCheckpointManager,
                                        leaf_from_bytes, leaf_to_bytes,
                                        tree_from_numpy)
    from repro_torch.core import ErdaStore, ServerConfig, make_store
    from repro_torch.kernels import ops
    from repro_torch.serving import ErdaKVPageStore
    cfg = ServerConfig(device_size=2 << 20, table_capacity=1 << 8, n_heads=1,
                       region_size=256 << 10, segment_size=32 << 10)
    calls = [lambda: ErdaStore(cfg),
             lambda: make_store("erda", cfg=cfg),
             lambda: make_store("erda-cluster", n_shards=1, cfg=cfg),
             lambda: ErdaKVPageStore(),
             lambda: ErdaCheckpointManager(),
             lambda: leaf_from_bytes(leaf_to_bytes(torch.ones(2))),
             lambda: tree_from_numpy({"a": 1}),
             lambda: ops.crc32_bytes_batch([b"abc"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_modules_import_here():
    for name in port_modules():
        importlib.import_module(name)
