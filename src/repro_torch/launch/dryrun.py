"""Multi-pod dry-run: run every (arch × shape) cell's step on the production
meshes with meta tensors (no allocation, no data), count one device's work
and emit the roofline terms — the port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \
        --shape train_4k --mesh single --out artifacts/dryrun

Where the reference lowers and compiles against 512 forced host devices,
the port starts torch's ``fake`` process group of 256 (single) or 512
(multi) ranks in this process (``launch.mesh.fake_world``) before any mesh
exists, builds the cell's train state or parameters and its inputs on the
meta device (``init_abstract``, ``input_specs``: shapes and dtypes, no
storage), distributes them as DTensors by the sharding rules
(``param_specs``, ``batch_spec``, ``cache_specs``) with the activation axes
set as ``lower_cell`` sets them, and runs the step — ``train_step`` (loss,
gradients, AdamW), ``prefill`` or ``decode_step`` — inside
``implicit_replication()``, since the models make plain tensors (RoPE
tables, masks) beside the DTensors.  Meta tensors, not ``FakeTensorMode``:
DTensor computes a strided shard's local size with a real ``arange`` and
``tolist`` (the sequence-parallel (B, S, d) activations flattened into a
matmul), which a fake tensor refuses.  DTensor plans its redistributions
greedily while the step runs (``greedy_redistribution``).

What is counted (``StepCounter``), all of ONE device's share (rank 0's
local shards; DTensor runs each op on them after placing it):
  * FLOPs of every local op, by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``, decomposing an op it has
    no formula for as ``FlopCounterMode`` does);
  * bytes: each local op that is not a view reads its inputs and writes its
    outputs once (eager, unfused);
  * collectives: each c10d functional collective DTensor issues, as (kind,
    payload bytes of its per-device result, group size) for
    ``roofline.analysis.collective_bytes``; a group of one rank moves
    nothing and is not recorded;
  * the temp peak: the high-water mark of the bytes of storages the step
    allocated and still holds — an ESTIMATE (eager order, no allocator).
Per-device argument and output bytes come exactly from the local shard
shapes.  Totals are per-device counts times the chips, as the reference's
``hlo_flops_total`` (``FlopCounterMode`` over the DTensor program counts
the global FLOPs instead: equal on one device, below the total wherever a
replicated op runs on every device).

The reference's depth fit (``--fit``, ``run_cell_fit``) extrapolates
because XLA's ``cost_analysis`` counts a scan body once.  The port's layers
are Python loops counted whole, so ``--fit`` runs the plain count.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, cell_applicable, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16, fake_world,
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.analysis import model_flops_for, roofline_terms
from repro_torch.sharding import MeshInfo, batch_spec, cache_specs, param_specs
from repro_torch.sharding.rules import (batch_axes, distribute_tree,
                                        set_activation_batch_axes, set_policy)
from repro_torch.train import make_train_step
from repro_torch.train.step import make_train_state_abstract
from repro_torch.tree import flatten_with_path


# gradient-accumulation policy for cells whose single-shot activations are too
# tight at 16 GB/chip (the reference's, kept so that the cells are the same)
MICROBATCH_POLICY = {
    ("mixtral_8x22b", "train_4k"): 4,
}

#: mesh kind -> (ranks of the fake world, mesh factory)
MESHES = {
    "single": (256, lambda: make_production_mesh(multi_pod=False)),
    "multi": (512, lambda: make_production_mesh(multi_pod=True)),
    "one": (1, lambda: make_test_mesh(data=1, model=1)),   # one GPU
}

#: c10d functional collectives -> the reference's HLO kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for _p, t in flatten_with_path(tree) if isinstance(t, torch.Tensor)]


def _group_size(func, args) -> int:
    """The rank count of a collective's group, from its group-name argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


class StepCounter:
    """A dispatch mode counting one device's local ops (see the module
    docstring).  Ops on DTensors are let through to DTensor first, so that
    only their local ops and collectives are counted."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(self, func, types, args, kwargs or {})

        self.mode = _Mode()
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.records: List[Tuple[str, int, int]] = []
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self.last_dtensor_op = None  # what DTensor placed last, for errors

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def _dispatch(self, mode, func, types, args, kwargs):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.last_dtensor_op = (str(func), [tuple(a.placements) for a in args
                                                if isinstance(a, DTensor)])
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) or any(
                isinstance(t, FakeTensor) for t in _tensors(args)):
            # DTensor infers an op's global output shape by running it on
            # fake global-shaped tensors: no device runs that
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry and func is not torch.ops.prim.device.default:
            with mode:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        if name in _COLLECTIVES and func.namespace in ("_c10d_functional", "c10d_functional"):
            n = _group_size(func, args)
            if n > 1:
                self.records.append((_COLLECTIVES[name], sum(t.nbytes for t in _tensors(out)), n))
        if not func.is_view and name != "wait_tensor":
            outs = _tensors(out)
            self.bytes += sum(t.nbytes for t in _tensors(args) + _tensors(kwargs) + outs)
            for t in outs:
                self._hold(t)
        return out


@contextlib.contextmanager
def greedy_redistribution():
    """While entered, DTensor plans every redistribution — the ones it
    prices to choose an op's strategy and the ones it runs — greedily, one
    mesh dim at a time, as it does wherever no tensor dim shards over
    several mesh dims.  Its min-cost graph search for the other cases
    (torch 2.13) takes seconds an op on a 2-D mesh and does not finish on
    a 3-D one.  A torch without that search is left as it is."""
    from torch.distributed.tensor import _redistribute as R
    planner = getattr(R, "DTensorRedistributePlanner", None)
    if planner is None or not hasattr(planner, "generate_graph_based_transform_infos"):
        yield
        return
    graph = planner.generate_graph_based_transform_infos
    planner.generate_graph_based_transform_infos = \
        lambda self, src, dst, _shape: self.generate_greedy_transform_infos(src, dst)
    try:
        yield
    finally:
        planner.generate_graph_based_transform_infos = graph


def _local_bytes(tree) -> int:
    """Bytes of this device's shards of a tree's leaves."""
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes for t in _tensors(tree))


def _set_activation_axes(shape: ShapeConfig, info: MeshInfo, policy: str) -> None:
    """As ``lower_cell``: batch axes when the batch shards (no-op when it
    can't, e.g. long_500k's B=1 — the caches' sequence sharding covers
    that).  ``lower_cell`` also sets the sequence axis, which the port has
    not (``sharding.rules.constrain_batch``)."""
    set_policy(policy)
    dsz = info.data_size * (info.model_size if policy == "dp" else 1)
    if shape.global_batch % dsz == 0:
        set_activation_batch_axes(batch_axes(info))
    elif shape.global_batch % info.data_size == 0:
        set_activation_batch_axes(info.data_axes)
    else:
        set_activation_batch_axes(None)


def count_cell(cfg, shape: ShapeConfig, mesh, *, policy: str = "tp",
               microbatches: int = 1) -> dict:
    """Run one cell's step on ``mesh`` with meta tensors and count it:
    {"counter": StepCounter, "argument": bytes, "output": bytes, "run_s"}.
    The activation axes and the policy are reset afterwards."""
    from torch.distributed.tensor.experimental import implicit_replication
    info = MeshInfo(mesh)
    model = get_model(cfg, "cpu")
    _set_activation_axes(shape, info, policy)
    try:
        inputs = model.input_specs(shape)
        if shape.kind == "train":
            state = make_train_state_abstract(model, max_seq=shape.seq_len)
            pspec = param_specs(state["params"], info, cfg.n_experts)
            state = {"params": distribute_tree(state["params"], pspec, mesh),
                     "opt": {"m": distribute_tree(state["opt"]["m"], pspec, mesh),
                             "v": distribute_tree(state["opt"]["v"], pspec, mesh),
                             "step": state["opt"]["step"]}}
            batch = distribute_tree(inputs, batch_spec(inputs, info), mesh)
            step = make_train_step(model, AdamWConfig(), n_microbatches=microbatches)
            args = (state, batch)
        else:
            params = model.init_abstract(max_seq=shape.seq_len)
            params = distribute_tree(params, param_specs(params, info, cfg.n_experts), mesh)
            if shape.kind == "prefill":
                batch = distribute_tree(inputs, batch_spec(inputs, info), mesh)
                step, args = model.prefill, (params, batch)
            else:
                cache = distribute_tree(inputs["cache"], cache_specs(
                    inputs["cache"], info, batch_size=shape.global_batch), mesh)
                token = distribute_tree({"t": inputs["token"]},
                                        batch_spec({"t": inputs["token"]}, info), mesh)["t"]
                step, args = model.decode_step, (params, cache, token)
        t0 = time.time()
        with greedy_redistribution(), implicit_replication(), StepCounter() as counter:
            try:
                out = step(*args)
            except RuntimeError as e:
                raise RuntimeError(f"{cfg.name} {shape.name}: the last op DTensor "
                                   f"placed: {counter.last_dtensor_op}") from e
        run_s = time.time() - t0
        return {"counter": counter, "argument": _local_bytes(args),
                "output": _local_bytes(out), "run_s": run_s}
    finally:
        set_activation_batch_axes(None)
        set_policy("tp")


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str | None,
             overrides: dict | None = None, policy: str = "tp", *,
             shape: Optional[ShapeConfig] = None, tag: str = "") -> dict:
    """One cell's record: ``RooflineReport.to_json()`` plus
    ``bytes_per_device``, ``lower_s`` and ``ok``, as the reference's
    ``run_cell``.  ``shape`` runs a ShapeConfig that is not in ``SHAPES``
    (its name stands in the record).  Starts the fake world the mesh needs
    unless a process group stands."""
    import torch.distributed as dist
    cfg = get_config(arch)
    micro_override = None
    if overrides:
        overrides = dict(overrides)
        micro_override = overrides.pop("microbatches", None)
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    ranks, build = MESHES[mesh_kind]
    if not dist.is_initialized():
        fake_world(ranks)
    mesh = build()
    chips = mesh.size()
    micro = (micro_override if micro_override is not None
             else MICROBATCH_POLICY.get((arch, shape_name), 1))
    t0 = time.time()
    got = count_cell(cfg, shape, mesh, policy=policy,
                     microbatches=micro if shape.kind == "train" else 1)
    t_lower = time.time() - t0
    c = got["counter"]
    report = roofline_terms(arch=arch, shape=shape.name, mesh_name=mesh_kind,
                            chips=chips, cost={"flops": c.flops, "bytes accessed": c.bytes},
                            records=c.records, model_flops=model_flops_for(cfg, shape))
    rec = report.to_json()
    rec.update(
        lower_s=round(t_lower, 1), step_s=round(got["run_s"], 1),
        flops_per_device=c.flops, bytes_per_device_accessed=c.bytes,
        bytes_per_device={
            "argument": got["argument"], "output": got["output"],
            "temp": c.peak, "peak": got["argument"] + c.peak,
            "temp_note": "estimate: high-water mark of the live local bytes "
                         "the step allocated, in eager order",
        },
        peaks={"flops": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW, "link_bw": LINK_BW,
               "source": "NVIDIA H100 SXM5 datasheet (launch/mesh.py)"},
        policy=policy, microbatches=micro if shape.kind == "train" else 1,
        layers=cfg.n_layers, ok=True,
    )
    print(f"[dryrun] {arch} × {shape.name} × {mesh_kind}: "
          f"count {got['run_s']:.1f}s  "
          f"args {got['argument'] / 2**30:.2f} GiB/dev  "
          f"temp {c.peak / 2**30:.2f} GiB/dev (estimate)  "
          f"dominant={rec['dominant']}")
    print(f"  flops/dev={c.flops:.3e} bytes/dev={c.bytes:.3e} "
          f"collective bytes/dev={report.collective_bytes_per_chip:.3e}")
    if out_dir:
        p = pathlib.Path(out_dir)
        p.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        (p / f"{arch}__{shape.name}__{mesh_kind}{suffix}.json").write_text(
            json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=list(MESHES))
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--fit", action="store_true",
                    help="the reference's depth fit; here the plain count, since "
                         "the port's layers are loops counted whole")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of ModelConfig field overrides (perf experiments)")
    ap.add_argument("--policy", default="tp", choices=["tp", "dp", "serve"],
                    help="sharding policy (perf experiments)")
    ap.add_argument("--tag", default="", help="output filename suffix")
    args = ap.parse_args(argv)
    if not cell_applicable(args.arch, args.shape):
        print(f"[dryrun] SKIP {args.arch} × {args.shape} (see DESIGN.md §5)")
        return
    overrides = json.loads(args.overrides) if args.overrides else None
    run_cell(args.arch, args.shape, args.mesh, args.out, overrides,
             policy=args.policy, tag=args.tag)


if __name__ == "__main__":
    main()
