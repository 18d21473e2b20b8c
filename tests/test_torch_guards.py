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
VERBATIM = ["core/hashtable.py", "core/log.py",
            "core/server.py", "core/recovery.py", "core/cleaning.py",
            "core/replication.py", "core/resharding.py",
            "core/baselines/redo_logging.py",
            "core/baselines/read_after_write.py",
            "fabric/transport.py", "fabric/sim.py",
            *sorted(str(p.relative_to(SRC / "repro"))
                    for d in ("configs", "data", "netsim", "workloads")
                    for p in (SRC / "repro" / d).glob("*.py")
                    if p.relative_to(SRC / "repro").as_posix() != "configs/base.py")]
#: copies the port changes, with the functions it changes; every other
#: top-level function and method must stay the reference's
CHANGED = {
    # the port's hybrid_moe family (granite 4.0-H): its fields, a softmax
    # scale, one layer of each mixer when scaled down, its exact count
    "configs/base.py": {"ModelConfig.__post_init__", "ModelConfig.attn_scale",
                        "ModelConfig.scaled_down", "ModelConfig.param_count"},
    "core/client.py": {"ErdaClient.__init__", "ErdaClient._parse_object",
                       "ErdaClient.multi_read", "ErdaClient.multi_write"},
    "core/api.py": {"ErdaStore.__init__", "ErdaClusterStore.__init__",
                    "make_store"},
    "core/cluster.py": {"ErdaCluster.__init__", "ErdaCluster._connect"},
    "core/layout.py": {"verify_records", "view_record"},
    # the spans of repro_torch.tracing
    "nvmsim/device.py": {"NVMDevice.write", "NVMDevice.read"},
    "serving/load.py": {"capture_page_fetch_traces",
                        "capture_migration_traces"},
    # the DeviceMesh port: MeshInfo reads a torch mesh's names and sizes,
    # specs are the port's PartitionSpec, trees the port's, and the
    # activation hooks DTensor redistributions
    "sharding/rules.py": {"PartitionSpec.__new__", "PartitionSpec.__repr__", "is_spec",
                          "MeshInfo.axis_names", "MeshInfo.shape", "MeshInfo.multi_pod",
                          "MeshInfo.model_size", "MeshInfo.data_size",
                          "MeshInfo.fsdp_size", "placements", "distribute_tree",
                          "_redistribute", "constrain_batch_only", "constrain_batch",
                          "replicate_dim", "splittable", "lookup", "local_heads",
                          "_ContiguousGrad.forward", "_ContiguousGrad.backward",
                          "_SplittableGrad.forward", "_SplittableGrad.backward",
                          "splittable_grad",
                          "_path_str", "param_specs", "batch_spec",
                          "_dtype_name", "cache_specs"},
    # collectives come as records, not HLO text; the H100's peaks
    "roofline/analysis.py": {"collective_bytes", "roofline_terms"},
    "launch/sweep.py": set(),
}
#: reference functions a changed copy drops, with what replaced them
DROPPED = {"roofline/analysis.py": {"_shape_bytes",                  # collective_bytes
                                   "collective_bytes_from_hlo"},
           # DTensor cannot carry sequence parallelism (rules.constrain_batch)
           "sharding/rules.py": {"set_activation_seq_axis"}}


def port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_repro():
    """In a fresh interpreter: import every module of repro_torch, serve,
    train, prefill a local_global config past its window and a MoE config,
    prefill and decode the rwkv, hybrid and encdec families, run a store
    round trip and serve KV pages at load on the CPU, and find no jax /
    repro in sys.modules."""
    code = f"""
import importlib, sys
import torch
for name in {port_modules()!r}:
    importlib.import_module(name)
from repro_torch.configs import get_config
from repro_torch.core import ServerConfig, make_store
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train
assert serve(batch=1, prompt_len=8, tokens=3, snapshot_every=1, crash_at=1,
             device="cpu").shape == (1, 3)
assert len(train(steps=2, batch=2, seq=16, ckpt_every=1, log_every=0,
                 device="cpu")[1]) == 2
import dataclasses
from repro_torch.models import get_model
lg = get_model(dataclasses.replace(get_config("gemma3_27b").scaled_down(),
                                   n_layers=8), "cpu")
logits, cache = lg.prefill(lg.init(0), dict(tokens=[[1] * 80]))
assert logits.shape == (1, 1, 512) and sorted(cache) == ["full", "local", "pos", "tail"]
moe = get_model(get_config("granite_moe_3b").scaled_down(), "cpu")
assert moe.prefill(moe.init(0), dict(tokens=[[1] * 24]))[0].shape == (1, 1, 512)
import numpy as np
for arch in ("rwkv6_1p6b", "zamba2_1p2b", "whisper_small"):
    cfg = get_config(arch).scaled_down()
    m = get_model(cfg, "cpu")
    batch = dict(tokens=[[1] * 24])
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((1, cfg.encoder_seq, cfg.d_model), np.float32)
    logits, cache = m.decode_step(m.init(0), m.prefill(m.init(0), batch)[1], torch.ones((1, 1), dtype=torch.int32))
    assert logits.shape == (1, 1, 512), arch
s = make_store("erda-cluster", n_shards=2, replication=2, device="cpu",
               cfg=ServerConfig(device_size=4 << 20, table_capacity=1 << 9,
                                n_heads=2, region_size=256 << 10,
                                segment_size=32 << 10))
s.multi_write([(k, bytes([k]) * k) for k in range(1, 20)])
assert s.multi_read(list(range(1, 20))) == [bytes([k]) * k for k in range(1, 20)]
from repro_torch.serving import serve_kv_at_load
assert serve_kv_at_load(100, horizon_s=0.001, device="cpu")["completed"] > 0
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


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(root, line) for root, line in imported_roots(path)
           if root in FORBIDDEN_ROOTS]
    assert not bad, f"{path}: {bad}"


#: the layers above the kernels and the protocol core, which import them
UPPER = ("repro_torch.sharding", "repro_torch.models", "repro_torch.serving")


def imported_modules(path: Path):
    """Every module ``path`` imports by absolute name, and for ``from m
    import n`` also ``m.n`` (n may be a module)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", sorted((PORT / "kernels").rglob("*.py"))
                         + sorted((PORT / "core").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_kernels_and_core_import_nothing_above_them(path):
    bad = sorted({m for m in imported_modules(path)
                  if any(m == up or m.startswith(up + ".") for up in UPPER)})
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
    allowed, dropped = CHANGED[rel], DROPPED.get(rel, set())
    assert allowed <= set(port)
    assert dropped <= set(ref) - set(port)
    for name, dump in ref.items():
        if name not in allowed | dropped:
            assert port.get(name) == dump, f"{rel}: {name} drifted"
    assert set(port) - set(ref) <= allowed


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.checkpoint import (ErdaCheckpointManager,
                                        leaf_from_bytes, leaf_to_bytes,
                                        tree_from_numpy)
    from repro_torch.core import ErdaStore, ServerConfig, make_store
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import checkpoint_manager_for, train
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy, train_state_from_numpy
    from repro_torch.serving import (ErdaKVPageStore, ServeEngine,
                                     capture_page_fetch_traces,
                                     serve_kv_at_load)
    from repro_torch.train.step import make_train_state
    cfg = ServerConfig(device_size=2 << 20, table_capacity=1 << 8, n_heads=1,
                       region_size=256 << 10, segment_size=32 << 10)
    olmo = get_config("olmo_1b").scaled_down()
    cpu_model = get_model(olmo, "cpu")
    cpu_params = cpu_model.init(0)
    calls = [lambda: ErdaStore(cfg),
             lambda: make_store("erda", cfg=cfg),
             lambda: make_store("erda-cluster", n_shards=1, cfg=cfg),
             lambda: ErdaKVPageStore(),
             lambda: ErdaCheckpointManager(),
             lambda: leaf_from_bytes(leaf_to_bytes(torch.ones(2))),
             lambda: tree_from_numpy({"a": 1}),
             lambda: ops.crc32_bytes_batch([b"abc"]),
             lambda: get_model(olmo).init(0),
             *[lambda arch=arch: get_model(get_config(arch).scaled_down())
               for arch in ("rwkv6_1p6b", "zamba2_1p2b", "whisper_small")],
             lambda: params_from_numpy({"embed": {}, "final_norm": {},
                                        "layers": {}}, olmo),
             lambda: ServeEngine(cpu_model, cpu_params),
             lambda: serve(batch=1, prompt_len=8, tokens=2),
             lambda: train(steps=1, batch=2, seq=16),
             lambda: make_train_state(get_model(olmo)),
             lambda: train_state_from_numpy({"params": {}}, olmo),
             lambda: checkpoint_manager_for(1 << 20),
             lambda: serve_kv_at_load(100, horizon_s=0.001),
             lambda: capture_page_fetch_traces(batches=(1,))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_modules_import_here():
    for name in port_modules():
        importlib.import_module(name)
