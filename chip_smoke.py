#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py                   # every phase, as the chip check runs it
    python3 chip_smoke.py --phases crc32    # a subset, for debugging

Phases, each printing one JSON line and raising on any mismatch:
  device      torch / CUDA versions, the card's name and power limit, and the
              build of every kernel from src/repro_torch/kernels/csrc/;
  crc32       the CRC-32 kernel against its plain PyTorch version and host
              zlib, exactly, with kernel / plain / zlib times;
  kv_pages    the KV page store at olmo_1b decode-cache widths: snapshot,
              restore, a torn snapshot, failover — every restore bit-exact;
  checkpoint  the checkpoint manager on an olmo_1b-width bf16 state: save,
              restore, writer crash, torn manifest, server crash recovery;
  kernels     one JSON line per ported kernel: launches on the main path,
              agreement with the plain version, time beside its bound.
The last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and float32 operations/s
#: outside the tensor cores — the rate the CRC's integer steps are held to
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
#: integer operations per CRC byte step: xor, and, table load, shift, xor
CRC_OPS_PER_BYTE = 5

#: olmo_1b widths (src/repro/configs/olmo_1b.py)
OLMO_1B = dict(d_model=2048, n_kv_heads=16, head_dim=128, d_ff=8192,
               vocab=50304, n_layers=16)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, dev) -> tuple:
    """Host time of one ``fn`` call ending in a device synchronise."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def random_words(shape, seed: int, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-2**31, 2**31, shape, generator=g, dtype=torch.int32,
                         device=dev)


def zlib_rows(words) -> list:
    host = words.cpu().numpy()
    return [zlib.crc32(row.tobytes()) for row in host]


def crc_bound_ms(n: int, w: int) -> tuple:
    """The least time the card could take for an (n, w) batch: words read
    once and CRCs written once over HBM, against the integer steps over the
    CUDA-core rate.  Returns (ms, "bytes" | "operations")."""
    t_bytes = (n * w * 4 + n * 4) / HBM_BYTES_PER_S
    t_ops = n * w * 4 * CRC_OPS_PER_BYTE / CUDA_CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases
def phase_device() -> dict:
    import torch
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in build.BUILD_LOG.values()
             for ln in log.splitlines() if "ptxas info" in ln]
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "build_s": build_s, "ptxas": ptxas}
    emit("device", **info)
    return info


def phase_crc32(dev) -> None:
    """Kernel vs plain version vs zlib, exactly, at the listed shapes."""
    from repro_torch.kernels import ops, ref
    for i, (n, w) in enumerate([(1, 1), (1000, 3), (512, 256), (2048, 16400)]):
        data = random_words((n, w), seed=i, dev=dev)
        got = ops.crc32_batch(data)
        plain = ref.crc32_ref(data)
        check(bool((got == plain).all()), f"crc32 kernel != plain at {(n, w)}")
        t0 = time.perf_counter()
        want = zlib_rows(data)
        zlib_ms = (time.perf_counter() - t0) * 1e3
        check(got.cpu().tolist() == want, f"crc32 kernel != zlib at {(n, w)}")
        emit("crc32", shape=[n, w],
             ms=cuda_ms(lambda: ops.crc32_batch(data), 20),
             plain_ms=cuda_ms(lambda: ref.crc32_ref(data), 1),
             zlib_ms=zlib_ms, bound_ms=crc_bound_ms(n, w)[0], exact=True)
    # 4 MiB records (a checkpoint shard): against zlib only — the plain
    # version's per-byte loop would take minutes at this width
    n, w = 120, 1048581
    data = random_words((n, w), seed=99, dev=dev)
    got = ops.crc32_batch(data)
    t0 = time.perf_counter()
    want = zlib_rows(data)
    zlib_ms = (time.perf_counter() - t0) * 1e3
    check(got.cpu().tolist() == want, "crc32 kernel != zlib on 4 MiB rows")
    ms = cuda_ms(lambda: ops.crc32_batch(data), 3)
    emit("crc32", shape=[n, w], ms=ms, plain_ms=None, zlib_ms=zlib_ms,
         bound_ms=crc_bound_ms(n, w)[0], exact=True,
         byte_step_ns=ms * 1e6 / (4 * w))


def make_kv_cache(shape, seed: int, dev):
    """A decode cache as a page tree: {'layers': [{'k': [page]*P, 'v': ...}]}
    — one (page_tokens, kv_heads, head_dim) bf16 leaf per page, leaves in the
    same order as the dense (layers, 2, P, ...) tensor they view."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    full = torch.randn(shape, generator=g, dtype=torch.bfloat16, device=dev)
    tree = {"layers": [{"k": list(full[l, 0]), "v": list(full[l, 1])}
                       for l in range(shape[0])]}
    return full, tree


def run_kv_pages(dev, *, n_seqs: int = 4, tokens: int = 1024,
                 layers: int = OLMO_1B["n_layers"], page_tokens: int = 16,
                 kv_heads: int = OLMO_1B["n_kv_heads"],
                 head_dim: int = OLMO_1B["head_dim"], n_shards: int = 4,
                 cfg=None) -> dict:
    """KV page store, 2-way mirrored, every restore bit-exact: snapshot and
    restore each sequence; a snapshot torn on a primary restores the previous
    version; a clean re-snapshot, fail_shard(0) + failover(0) and a restore
    of every sequence."""
    import torch
    from repro_torch.core import make_store
    from repro_torch.kernels import ops
    from repro_torch.nvmsim.device import TornWrite
    from repro_torch.serving import PAGE_SHARD_CONFIG, ErdaKVPageStore
    from repro_torch.serving.kv_store import _page_key
    from repro_torch.tree import flatten_with_path

    shape = (layers, 2, tokens // page_tokens, page_tokens, kv_heads, head_dim)
    pages = shape[0] * shape[1] * shape[2]
    # the default 256 MiB shard fills with two versions of every page
    cfg = cfg or dataclasses.replace(PAGE_SHARD_CONFIG, device_size=512 << 20)
    store = ErdaKVPageStore(make_store("erda-cluster", n_shards=n_shards,
                                       replication=2, cfg=cfg, device=dev),
                            device=dev)
    count = ops.COUNTS["crc32_batch"]

    def restore_equal(seq: int, full, tree) -> int:
        rows0 = count.rows
        got = store.restore_cache(seq, tree)
        check(got is not None, f"seq {seq}: restore found no snapshot")
        stacked = torch.stack([leaf for _p, leaf in flatten_with_path(got)])
        check(torch.equal(stacked.view(shape), full),
              f"seq {seq}: restored pages differ")
        return count.rows - rows0

    caches = [make_kv_cache(shape, seed=s, dev=dev) for s in range(n_seqs)]
    ops.reset_counts()  # the main path starts here
    out = {"pages_per_seq": pages, "page_bytes": page_tokens * kv_heads * head_dim * 2,
           "shard_config": dataclasses.asdict(cfg)}
    ms, _ = wall_ms(lambda: [store.snapshot_cache(s, c[1])
                             for s, c in enumerate(caches)], dev)
    out["snapshot_ms"] = ms / n_seqs
    t0 = time.perf_counter()
    for s, (full, tree) in enumerate(caches):
        rows = restore_equal(s, full, tree)
        check(dev.type == "cpu" or rows == pages,
              f"seq {s}: verified {rows} rows for {pages} pages")
    out["restore_ms"] = (time.perf_counter() - t0) * 1e3 / n_seqs
    out["restore_rows"] = count.rows

    # a snapshot torn on the primary of the shard its first page goes to:
    # that shard's batch raises before any other shard is written, so every
    # page must restore at its previous version (CRC fallback + repair)
    full2, tree2 = make_kv_cache(shape, seed=1000, dev=dev)
    first = _page_key(0, flatten_with_path(tree2)[0][0], 0)
    shard = store.store.shard_for_key(first)
    store.store.group(shard).primary.server.dev.fault.arm(countdown=0,
                                                          fraction=0.5)
    try:
        store.snapshot_cache(0, tree2)
        torn = False
    except TornWrite:
        torn = True
    check(torn, "armed fault did not tear the snapshot")
    fallbacks0 = store.stats["fallbacks"]
    restore_equal(0, *caches[0])
    out["torn_fallbacks"] = store.stats["fallbacks"] - fallbacks0
    check(out["torn_fallbacks"] > 0, "torn snapshot took no CRC fallback")

    # acknowledged re-snapshot, then lose shard 0's primary and fail over
    store.snapshot_cache(0, tree2)
    caches[0] = (full2, tree2)
    restore_equal(0, full2, tree2)
    store.fail_shard(0)
    ms, _ = wall_ms(lambda: store.failover(0), dev)
    out["failover_ms"] = ms
    for s, (full, tree) in enumerate(caches):
        restore_equal(s, full, tree)
    out["launches"] = count.launches
    out["rows"] = count.rows
    out["shapes"] = {str(k): v for k, v in count.shapes.items()}
    check(dev.type == "cpu" or count.launches > 0, "kv path launched no CRC kernel")
    return out


def olmo_state(seed: int, dev, *, d: int, d_ff: int, vocab: int,
               n_layers: int = 2):
    """Token embedding plus ``n_layers`` full decoder layers at the given
    widths, in bf16."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=g, dtype=torch.bfloat16, device=dev)
    return {"embed": w(vocab, d),
            "layers": [{"q": w(d, d), "k": w(d, d), "v": w(d, d), "o": w(d, d),
                        "w1": w(d, d_ff), "w3": w(d, d_ff), "w2": w(d_ff, d)}
                       for _ in range(n_layers)],
            "step": torch.tensor(seed, dtype=torch.int32, device=dev)}


def run_checkpoint(dev, *, d: int = OLMO_1B["d_model"],
                   d_ff: int = OLMO_1B["d_ff"], vocab: int = OLMO_1B["vocab"],
                   shard_bytes: int = 4 << 20, device_size: int = 2 << 30) -> dict:
    """Checkpoint manager: save steps 1 and 2, restore; writer crash in step
    3; a torn manifest write; server crash recovery — each restore bit-exact
    at step 2."""
    import torch
    from repro_torch.checkpoint import ErdaCheckpointManager
    from repro_torch.checkpoint.erda_ckpt import MANIFEST_KEY
    from repro_torch.core import ErdaStore, ServerConfig
    from repro_torch.kernels import ops
    from repro_torch.nvmsim.device import TornWrite
    from repro_torch.tree import flatten_with_path

    # two shard records fit one segment (the manager's default 8 MiB segment
    # holds one 4 MiB shard plus header, wasting half the log), and four heads
    # keep the recovery scan's free-space walk short
    seg = 2 * shard_bytes + (64 << 10)
    cfg = ServerConfig(device_size=device_size, table_capacity=1 << 15,
                       n_heads=4, region_size=2 * seg, segment_size=seg)
    mgr = ErdaCheckpointManager(ErdaStore(cfg, device=dev), device=dev,
                                shard_bytes=shard_bytes)
    count = ops.COUNTS["crc32_batch"]
    states = {s: olmo_state(s, dev, d=d, d_ff=d_ff, vocab=vocab)
              for s in (1, 2, 3)}
    nbytes = sum(t.numel() * t.element_size()
                 for _p, t in flatten_with_path(states[1]))

    def restored_equal(want_step: int, what: str) -> float:
        ms, (step, got) = wall_ms(lambda: mgr.restore(states[1]), dev)
        check(step == want_step, f"{what}: restored step {step}, want {want_step}")
        for (p, a), (_q, b) in zip(flatten_with_path(got),
                                   flatten_with_path(states[want_step])):
            check(a.device.type == dev.type and torch.equal(a, b),
                  f"{what}: leaf {p} differs")
        return ms

    ops.reset_counts()  # the main path starts here
    out = {"state_bytes": nbytes, "device_size": device_size}
    out["save_ms"], shards = wall_ms(lambda: mgr.save(1, states[1]), dev)
    out["shards"] = shards
    mgr.save(2, states[2])
    out["restore_ms"] = restored_equal(2, "restore")
    out["restore_launches"] = count.launches
    try:
        mgr.save(3, states[3], fail_after_shards=shards // 2)
        crashed = False
    except RuntimeError as e:
        if "injected checkpoint-writer crash" not in str(e):
            raise
        crashed = True
    check(crashed, "injected writer crash did not fire")
    restored_equal(2, "after writer crash")
    mgr.store.dev.fault.arm(countdown=0, fraction=0.4)
    try:
        mgr.store.write(MANIFEST_KEY, json.dumps({"step": 99, "entries": []}).encode())
        torn = False
    except TornWrite:
        torn = True
    check(torn, "armed fault did not tear the manifest")
    restored_equal(2, "after torn manifest")
    out["recover_ms"], stats = wall_ms(mgr.crash_recover, dev)
    out["recover"] = stats
    restored_equal(2, "after crash recovery")
    out["launches"] = count.launches
    out["rows"] = count.rows
    out["shapes"] = {str(k): v for k, v in count.shapes.items()}
    check(dev.type == "cpu" or count.launches > 0,
          "checkpoint path launched no CRC kernel")
    return out


def phase_kernels(dev, launches: int, shapes: dict) -> dict:
    """Time the CRC kernel at the main path's batch with the most rows (a KV
    restore's per-shard batch), beside its plain version and its bound."""
    from repro_torch.kernels import ops, ref
    n, w = max(shapes, key=lambda s: (s[0], s[1]))
    data = random_words((n, w), seed=7, dev=dev)
    got = ops.crc32_batch(data)
    plain = ref.crc32_ref(data)
    err = int((got - plain).abs().max().item())
    check(err == 0, f"crc32 kernel != plain at main-path shape {(n, w)}")
    bound, by = crc_bound_ms(n, w)
    return {"name": "crc32_batch", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/crc32.cu",
            "replaces": "src/repro/kernels/crc32.py:61",
            "launches": launches, "matches_plain": True, "max_abs_err": err,
            "shape": [n, w],
            "ms": cuda_ms(lambda: ops.crc32_batch(data), 10),
            "plain_ms": cuda_ms(lambda: ref.crc32_ref(data), 1),
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,crc32,kv_pages,checkpoint,kernels")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs the port on a CUDA device only", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    from repro_torch.kernels import ops
    info = phase_device()
    if "crc32" in phases:
        phase_crc32(dev)
    launches, shapes = 0, {}
    for name, run in (("kv_pages", run_kv_pages), ("checkpoint", run_checkpoint)):
        if name in phases:
            res = run(dev)
            emit(name, **res)
            launches += res["launches"]
            for k, v in ops.COUNTS["crc32_batch"].shapes.items():
                shapes[k] = shapes.get(k, 0) + v
    if "kernels" in phases and shapes:
        print(json.dumps({"kernels": [phase_kernels(dev, launches, shapes)]}),
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
