"""Logical-axis → mesh sharding rules (path-regex based, MaxText-style) — the
port of ``repro/sharding/rules.py`` onto a torch ``DeviceMesh``.

Mesh axes: ('pod', 'data', 'model') multi-pod, ('data', 'model') single-pod.
  pod    — pure DP: gradients cross the slow inter-pod links once per step
  data   — FSDP: the 'embed'-like dimension of every weight shards here, so a
           mixtral-8x22b train state (141B × 12B/param) fits 256×16 GB chips;
           weights are all-gathered per layer inside the scan (compute/comm
           overlap via the XLA latency-hiding scheduler)
  model  — TP: heads / d_ff / vocab / d_inner; EP when n_experts divides it

Batch shards over (pod, data); decode caches shard batch — or, when batch
can't shard (long_500k has B=1), the cache SEQUENCE dimension shards over
'data' (sequence parallelism for the KV pages).

The rule table, the policies and the spec functions are the reference's.
A spec is ``PartitionSpec`` here (``P``): a tuple whose entries are None, a
mesh axis name or a tuple of names.  ``placements`` maps it onto DTensor
placements, one a mesh dim, and ``distribute_tree`` distributes a tree by
its specs.  The port keeps per-layer lists where the reference stacks
layers (``models.convert``), so its leaves have no leading stack dims and
their specs are the reference's with the leading ``None``s dropped; paths
are rendered with slashes (``layers/0/attn/wq``) so the rules' ``$``-ended
regexes match them.  The activation hooks are ``DTensor.redistribute``
calls, the identity on a plain tensor or while no axes are set.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import flatten_with_path, unflatten


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a tensor dim; a tuple of
    one name is stored as the name, as JAX stores it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """A torch ``DeviceMesh`` (its ``mesh_dim_names`` and sizes), or any
    object with ``axis_names`` and a ``shape`` mapping of them."""
    mesh: Any

    @property
    def axis_names(self) -> Tuple[str, ...]:
        names = getattr(self.mesh, "mesh_dim_names", None)
        return tuple(names) if names is not None else tuple(self.mesh.axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        if getattr(self.mesh, "mesh_dim_names", None) is not None:
            return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        return dict(self.mesh.shape)

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axis_names

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def data_size(self) -> int:
        d = self.shape["data"]
        return d * (self.shape["pod"] if self.multi_pod else 1)

    @property
    def fsdp_size(self) -> int:
        return self.shape["data"]


# ---------------------------------------------------------------- placements
def placements(spec, mesh) -> tuple:
    """``spec`` as DTensor placements on ``mesh``, one a mesh dim:
    ``Shard(tensor dim)`` where the dim's entry names the mesh dim, else
    ``Replicate()``.  A tuple entry such as ``("pod", "data")`` shards one
    tensor dim over several mesh dims; its names must come in the mesh's
    dim order, so that the layout is JAX's major-to-minor one.  A mesh dim
    of size 1 replicates: the same layout, and DTensor refuses a view that
    merges or splits a dim sharded over it, which JAX allows."""
    from torch.distributed.tensor import Replicate, Shard
    info = MeshInfo(mesh)
    names, sizes = info.axis_names, info.shape
    owner: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        assert order == sorted(order), \
            f"{spec}: {axes} is not in the mesh's dim order {names}"
        for a in axes:
            assert a not in owner, f"{spec}: mesh axis {a!r} shards two dims"
            owner[a] = dim
    return tuple(Shard(owner[n]) if n in owner and sizes[n] > 1 else Replicate()
                 for n in names)


def distribute_tree(tree, specs, mesh):
    """``tree`` with every tensor leaf a DTensor on ``mesh``, placed by the
    matching leaf of ``specs`` (``param_specs``, ``batch_spec``,
    ``cache_specs``).  Every process holds the whole tree and keeps its own
    shard of it: nothing crosses between processes."""
    from torch.distributed.tensor import distribute_tensor
    leaves = [leaf for _p, leaf in flatten_with_path(tree)]
    spec_leaves = [s for _p, s in flatten_with_path(specs, is_leaf=is_spec)]
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    return unflatten(tree, [distribute_tensor(t, mesh, placements(s, mesh),
                                              src_data_rank=None)
                            for t, s in zip(leaves, spec_leaves)])


# --------------------------------------------------------------- activations
# Batch-dim sharding constraints for activations (MaxText-style): GSPMD can
# lose the batch sharding through gathers (embedding lookups), silently
# replicating (B,S,d) activations across the data axis.  Models call
# constrain_batch() at block boundaries; it is a no-op unless the launcher
# declared the activation batch axes for the current mesh.
_ACTIVATION_BATCH_AXES: Optional[Tuple[str, ...]] = None


def set_activation_batch_axes(axes: Optional[Tuple[str, ...]]) -> None:
    global _ACTIVATION_BATCH_AXES
    _ACTIVATION_BATCH_AXES = tuple(axes) if axes else None


def _redistribute(x, spec):
    """``jax.lax.with_sharding_constraint`` on a DTensor; a plain tensor
    passes unchanged."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def constrain_batch_only(x):
    """Pin dim0 to (pod,data) and force every other dim replicated.  Used at
    the MoE expert-FFN boundary: the dispatched activations must NOT carry the
    sequence's 'model' sharding, or it conflicts with the expert weights'
    TP-sharded d_ff and GSPMD falls back to fully replicating the experts."""
    if _ACTIVATION_BATCH_AXES is None or x.ndim < 2:
        return x
    spec = P(_ACTIVATION_BATCH_AXES, *([None] * (x.ndim - 1)))
    return _redistribute(x, spec)


def constrain_batch(x):
    """Pin dim0 of an activation to (pod, data).

    The reference also pins dim1 to the TP axis when divisible (sequence
    parallelism, its ``set_activation_seq_axis``, which the port drops with
    it: Megatron-style, the residual stream's S sharded over 'model' at
    block boundaries, re-gathered at the projections).  DTensor cannot carry that
    layout: a (B,S,d) activation whose S is sharded cannot enter ``x @ W``
    (its flattened (B·S, d) view is refused by torch 2.11 and becomes a
    strided shard whose redistribution search does not finish on a 3-D
    mesh in 2.13), so S would have to be gathered again at once and the
    carry would not be stored sharded either.  On a mesh S stays whole:
    the residual's partial sums are all-reduced where GSPMD reduce-scatters
    and all-gathers them (the same wire bytes)."""
    return constrain_batch_only(x)


def replicate_dim(x, dim: int):
    """A DTensor with ``dim`` gathered whole on every device (its other
    placements kept); a plain tensor passes unchanged.  The loss reads its
    gold logits so: with a vocab-sharded table (the rules' ``embed/table``)
    the logits' vocab dim is sharded, and DTensor's gather along it (its
    MaskPartial path) fails once the result meets another DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def lookup(table, idx):
    """``table[idx]``: the rows of a (V, d) table; a plain table is indexed
    as before.  A DTensor table has its vocab dim gathered whole first
    (``replicate_dim``: DTensor's lookup into a vocab-sharded table takes
    its MaskPartial path, which meta tensors refuse) and takes
    ``F.embedding`` (the backward of indexing, an accumulating
    ``index_put``, fails in torch 2.11's sharding propagation)."""
    from torch.distributed.tensor import DTensor
    if isinstance(table, DTensor):
        import torch.nn.functional as F
        return F.embedding(idx, replicate_dim(table, 0))
    return table[idx]


def splittable(x, dim: int, n: int):
    """A DTensor about to have ``dim`` split into (n, rest), e.g. a
    projection into heads: when the mesh dims that shard ``dim`` do not
    divide n, ``dim`` is gathered whole first (GSPMD reshards such a split
    by itself; DTensor refuses it).  A plain tensor passes unchanged."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    ways = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            ways *= x.device_mesh.size(i)
    return x if n % ways == 0 else replicate_dim(x, dim)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous on its way back:
    DTensor views a gradient's local shard (a reshape's backward) without
    copying, which a transposed shard from an attention's backward
    refuses."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_heads(fn):
    """``fn(q, k, v, ...)``, an attention whose (batch row, head) pairs are
    independent, over (B, S, heads, hd) tensors, run on each device's shards
    when q is a DTensor: every 4-D tensor argument keeps q's batch mesh
    dims, shards its heads over the mesh dim named 'model' where every head
    count divides (else replicates them), and is whole along its other
    dims; any other tensor argument is whole.  The result has q's global
    shape.  GSPMD partitions the reference's attention einsums so; DTensor
    cannot (their bmm merges the batch and head dims: torch 2.11 refuses
    that view of two sharded dims, 2.13 makes it a strided shard and then
    replicates the attention over 'model').  A plain q calls ``fn``."""
    import functools

    @functools.wraps(fn)
    def run(q, *args, **kwargs):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(q, DTensor):
            return fn(q, *args, **kwargs)
        mesh = q.device_mesh
        whole = (Replicate(),) * mesh.ndim
        heads = [t.shape[2] for t in (q, *args) if hasattr(t, "ndim") and t.ndim == 4]
        head_place = []
        for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, q.placements)):
            if isinstance(p, Shard) and p.dim == 0:
                head_place.append(Shard(0))
            elif name == "model" and all(h % mesh.size(i) == 0 for h in heads):
                head_place.append(Shard(2))
            else:
                head_place.append(Replicate())
        head_place = tuple(head_place)

        def local(t):
            if not hasattr(t, "ndim"):
                return t
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, whole, run_check=False)
            t = t.redistribute(mesh, head_place if t.ndim == 4 else whole).to_local()
            return _ContiguousGrad.apply(t) if t.requires_grad else t

        out = fn(local(q), *map(local, args), **kwargs)
        return DTensor.from_local(out, mesh, head_place, run_check=False)
    return run


# Sharding policy: 'tp' (default — TP over 'model', FSDP over 'data') or
# 'dp' (pure data parallel + FSDP over BOTH axes: right for small models whose
# TP collectives would dwarf their compute — see EXPERIMENTS.md §Perf).
_POLICY = "tp"


def set_policy(policy: str) -> None:
    global _POLICY
    assert policy in ("tp", "dp", "serve")
    _POLICY = policy


def get_policy() -> str:
    return _POLICY


# (regex, base_rank, trailing spec) — leading stacked-layer dims are padded
# with None.  Trailing spec axes: F = fsdp('data'), T = tp('model').
F, T = "data", "model"
_RULES = [
    (r"embed/table$",        2, (T, F)),
    (r"embed/unembed$",      2, (F, T)),
    (r"dec_pos$",            2, (None, F)),
    (r"attn/w[qkv]$",        2, (F, T)),
    (r"attn/wo$",            2, (T, F)),
    (r"mlp/w[gi]$",          2, (F, T)),
    (r"mlp/wo$",             2, (T, F)),
    (r"moe/router$",         2, (F, None)),
    (r"moe/w[gi]$",          3, "MOE_IN"),
    (r"moe/wo$",             3, "MOE_OUT"),
    (r"ssm/in_proj$",        2, (F, T)),
    (r"ssm/out_proj$",       2, (T, F)),
    (r"ssm/conv_w$",         2, (None, T)),
    (r"ssm/(A_log|D|dt_bias)$", 1, (None,)),
    (r"ssm/gate_norm$",      1, (T,)),
    (r"tm/w[rkvg]$",         2, (F, T)),
    (r"tm/wo$",              2, (T, F)),
    (r"tm/w_lora_a$",        2, (F, None)),
    (r"tm/w_lora_b$",        2, (None, T)),
    (r"tm/(mu|w0|u|ln)$",    0, "REPL"),
    (r"cm/w[rk]$",           2, (F, T)),
    (r"cm/wv$",              2, (T, F)),
    (r"cm/mu$",              0, "REPL"),
    (r"(ln1|ln2|ln_x|ln_in|ln|final_norm|enc_norm|gate_norm)(/scale)?$", 0, "REPL"),
]


def _path_str(path: str) -> str:
    """``tree.flatten_with_path``'s ``['layers'][0]['attn']['wq']`` as
    ``layers/0/attn/wq``."""
    return "/".join(key if key else idx
                    for key, idx in re.findall(r"\['([^']*)'\]|\[(\d+)\]", path))


def spec_for_param(path: str, shape: Tuple[int, ...], info: MeshInfo,
                   n_experts: int = 0) -> P:
    for regex, base_rank, trailing in _RULES:
        if re.search(regex, path):
            if trailing == "REPL":
                return P()
            if trailing == "MOE_IN":      # (E, d, f)
                if n_experts and n_experts % info.model_size == 0:
                    trailing = (T, F, None)       # true EP
                else:
                    trailing = (None, F, T)       # TP-MoE
            elif trailing == "MOE_OUT":   # (E, f, d)
                if n_experts and n_experts % info.model_size == 0:
                    trailing = (T, None, F)
                else:
                    trailing = (None, T, F)
            lead = len(shape) - len(trailing)
            spec = (None,) * lead + tuple(trailing)
            if _POLICY == "dp":
                # fold TP away; FSDP over the merged (data, model) axes
                spec = tuple(("data", "model") if ax == F else
                             (None if ax == T else ax) for ax in spec)
            elif _POLICY == "serve":
                # replicate params over 'data' (no per-layer FSDP gathers on
                # the decode path); TP over 'model' carries the weights
                spec = tuple(None if ax == F else ax for ax in spec)
            # drop shardings that don't divide (robustness for reduced configs)
            fixed = []
            for dim, ax in zip(shape, spec):
                if ax == ("data", "model"):
                    size = info.fsdp_size * info.model_size
                elif ax in (F, T):
                    size = {F: info.fsdp_size, T: info.model_size}.get(ax, 1)
                else:
                    size = 1
                fixed.append(ax if ax and dim % size == 0 and dim >= size else None)
            return P(*fixed)
    return P()  # default: replicate


def param_specs(params, info: MeshInfo, n_experts: int = 0):
    """Tree of PartitionSpec matching `params` (tensors, meta tensors too)."""
    return unflatten(params, [spec_for_param(_path_str(path), tuple(leaf.shape), info,
                                             n_experts)
                              for path, leaf in flatten_with_path(params)])


def batch_axes(info: MeshInfo):
    if _POLICY == "dp":
        return info.data_axes + ("model",)
    return info.data_axes


def batch_spec(batch, info: MeshInfo):
    """tokens/frames/patches: shard the leading batch dim over (pod, data)
    (+ 'model' under the dp policy)."""
    da = batch_axes(info)
    dsz = info.data_size * (info.model_size if _POLICY == "dp" else 1)

    def one(leaf):
        b = leaf.shape[0]
        if b % dsz == 0:
            return P(da, *([None] * (len(leaf.shape) - 1)))
        if b % info.data_size == 0:
            return P(info.data_axes, *([None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))
    return unflatten(batch, [one(leaf) for _p, leaf in flatten_with_path(batch)])


def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``torch.int8`` -> ``int8``)."""
    return str(dtype).rsplit(".", 1)[-1]


def cache_specs(cache, info: MeshInfo, *, batch_size: int):
    """Decode caches: shard batch over (pod,data) when divisible; otherwise
    (long_500k, B=1) shard the big sequence/capacity dimension over 'data'
    (sequence parallelism), heads over 'model'."""
    da = info.data_axes
    batch_ok = batch_size % info.data_size == 0

    def one(path, leaf):
        shape = tuple(leaf.shape)
        if _dtype_name(leaf.dtype).startswith("int") and len(shape) <= 2:
            # kv_pos (L, C): shard C over data in seq-parallel mode
            if not batch_ok and len(shape) == 2 and shape[1] % info.fsdp_size == 0:
                return P(None, F)
            return P(*([None] * len(shape)))
        if len(shape) == 0:
            return P()
        # find the batch dim: first dim equal to batch_size after leading stacks
        spec = [None] * len(shape)
        bdims = [i for i, s in enumerate(shape) if s == batch_size]
        if batch_ok and bdims:
            spec[bdims[0]] = da
            # shard heads/channels over model: prefer the second-to-last dim
            # (KV heads for attention caches, channels for states) — sharding
            # the capacity/sequence dim over 'model' would split the softmax
            candidates = [len(shape) - 2] + list(range(bdims[0] + 1, len(shape)))
            for i in candidates:
                if i <= bdims[0]:
                    continue
                if shape[i] % info.model_size == 0 and shape[i] >= info.model_size:
                    spec[i] = T
                    break
        elif not batch_ok:
            # sequence parallelism: shard the largest dim over data
            big = max(range(len(shape)), key=lambda i: shape[i])
            if shape[big] % info.fsdp_size == 0 and shape[big] > 1:
                spec[big] = F
            for i in range(len(shape)):
                if i != big and shape[i] % info.model_size == 0 and shape[i] >= info.model_size:
                    spec[i] = T
                    break
        return P(*spec)

    return unflatten(cache, [one(path, leaf) for path, leaf in flatten_with_path(cache)])
