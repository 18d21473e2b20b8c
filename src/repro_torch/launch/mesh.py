"""Production mesh definitions and the H100's peaks — the port of
``repro/launch/mesh.py`` onto torch ``DeviceMesh``es.

FUNCTIONS, not module-level constants: importing this module starts no
process group and allocates nothing.  A mesh is built on the process group
that stands: ``fake_world(n)`` starts torch's ``fake`` backend, one process
standing in for n ranks (the dry-run's counterpart of the reference's 512
forced host devices); ``one_card_mesh(device)`` starts NCCL with a world of
one; a launcher on a real cluster starts its own group first.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM5 (80 GB HBM3) peaks, per GPU, from the NVIDIA H100 Tensor
# Core GPU datasheet; the roofline's defaults
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12                # B/s
CUDA_CORE_FLOPS_F32 = 67e12     # FLOP/s, float32 outside the tensor cores
NVLINK_BW = 450e9               # B/s one way (NVLink 4: 900 GB/s both ways)
NET_BW = 50e9                   # B/s: one 400 Gb/s NDR InfiniBand port a GPU
# A 16-wide mesh axis spans two 8-GPU nodes, so every collective of the
# production meshes crosses the network: NET_BW is their link bandwidth.
# NVLINK_BW applies to an axis that stays inside one node.
LINK_BW = NET_BW


def _device_type() -> str:
    """The device type of the process group that stands: NCCL's is cuda,
    every other backend's (fake, gloo) cpu."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (fake_world, "
                           "one_card_mesh or the launcher's) before a mesh")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 GPUs per pod; 2 pods = 512 GPUs when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """Small mesh for CPU tests (on a ``fake_world`` or gloo group of
    pod·data·model ranks)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


def fake_world(n: int) -> None:
    """Start torch's ``fake`` process group of ``n`` ranks in this process
    (this process is rank 0; collectives move no data).  Raises if a group
    already stands."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(f"a process group already stands "
                           f"({dist.get_backend()}, world {dist.get_world_size()})")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def one_card_mesh(device):
    """A (1, 1) ``("data", "model")`` mesh on one CUDA device: an NCCL group
    of world size 1 over a ``HashStore``."""
    import torch.distributed as dist
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"one_card_mesh needs a CUDA device, not {device}")
    if dist.is_initialized():
        raise RuntimeError(f"a process group already stands ({dist.get_backend()})")
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", rank=0, world_size=1, store=dist.HashStore(),
                            device_id=device)
    return _mesh((1, 1), ("data", "model"))
