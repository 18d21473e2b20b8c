#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py                   # every phase, as the chip check runs it
    python3 chip_smoke.py --phases crc32    # a subset, for debugging

Phases, each printing one JSON line and raising on any mismatch:
  device      torch / CUDA versions, the card's name and power limit, and the
              build of every kernel from src/repro_torch/kernels/csrc/;
  crc32       the CRC-32 kernel against its plain PyTorch version and host
              zlib, exactly (widths at the kernel's chunk boundaries among
              them), with kernel / plain / zlib times, and alone at the
              serve restore's (3, 25165843), the serve_gemma3 restore's
              (6, 52428820), the serve_granite_moe restore's (3, 37748755)
              and the serve_gemma3_12b restore's (5, 41943060) against
              zlib and the bound;
  flash_attention  the flash-attention kernel (bf16: tensor-core route;
              f32: CUDA-core route) against its plain PyTorch version at the
              serve path's and olmo_1b's shapes and at the 64-key tile's
              edges (S = 64, 65, 100), with kernel / plain / SDPA times and
              the bound;
  kv_pages    the KV page store at olmo_1b decode-cache widths: snapshot,
              restore, a torn snapshot, failover — every restore bit-exact;
  checkpoint  the checkpoint manager on an olmo_1b-width bf16 state: save,
              restore, writer crash, torn manifest, server crash recovery;
  ycsb        the paper's comparison of Erda, Redo Logging and Read After
              Write on the DES, every Erda verify on the card's CRC kernel:
              each scheme's simulated read latency over 16 B - 4 KiB values
              (62 / 92 / 92 us, +- 4), server CPU and the NVM bytes of Table
              1; YCSB A, B and C at 1 KiB records (10,000 keys, 20,000 ops
              on a 4-shard erda-cluster, 16 contended threads; B also at
              batch 16); the kill-a-shard, quorum chaos and elastic runs,
              with no lost acknowledged write and no stale read; first
              ``des_check``: the DES workloads on the card against the CPU,
              reports equal;
  serve_at_load  KV page serving at offered load (examples/serve_kv.py's
              settings and 8 KiB pages) over page traces captured on the
              card: the p99 opens past the knee, deadline admission keeps
              goodput, shared-QP schedules are legal, every capture launched
              the CRC kernel;
  serve       olmo_1b at its full config (random weights from a seed): 4
              requests x 256 prompt tokens, 16 greedy tokens with decode-cache
              snapshots in the page store, clean and preempted at token 10 —
              the tokens must be equal and the bf16 prefill must take only
              the flash kernel's tensor-core route; first the model on the
              card against the CPU on a small f32 config;
  serve_gemma3  gemma3_27b at its full config (62 layers, 5:1 local:global,
              window 1024; 27.0e9 parameters, random from a seed): 1 request
              x 1536 prompt tokens past the window, 16 greedy tokens, clean
              and preempted at token 10 with ring caches restored from the
              page store — the tokens must be equal, the restore must launch
              the CRC kernel, and each prefill must launch the flash kernel
              exactly once a global layer (10), on the tensor-core route at
              (32, 1536, 128): the local layers' banded attention stays off
              it; first the local_global (8 layers, 160 tokens) and vlm
              (pixtral) models on the card against the CPU on small f32
              configs;
  serve_granite_moe  granite_moe_3b at its full config (32 MoE layers, 40
              experts top-8; 3.30e9 parameters, random from a seed): 4
              requests x 1024 prompt tokens (4 dispatch groups of 256 a row),
              16 greedy tokens, clean and preempted at token 10 — the tokens
              must be equal, the restore must launch the CRC kernel and each
              prefill must launch the flash kernel exactly once a layer (32)
              at (96, 1024, 64) on the tensor-core route; prints the pairs
              the prefill's capacity dropped; first the MoE models (granite
              at k = 8 in groups of 16, mixtral's swa past its window) on the
              card against the CPU on small f32 configs;
  serve_gemma3_12b  gemma3_12b at its full config (48 layers, 5:1
              local:global, head_dim 256; 11.8e9 parameters): 1 request x
              1536 prompt tokens, as serve_gemma3 — each prefill must launch
              the flash kernel exactly once a global layer (8) at (16, 1536,
              256); first gemma3_12b scaled down with head_dim 256 on the
              card against the CPU;
  serve_rwkv6  rwkv6_1p6b at its full config (24 layers, attention-free;
              1.45e9 parameters): 4 requests x 1024 prompt tokens, 16 greedy
              tokens, clean and preempted at token 10 — the tokens must be
              equal, the restore must launch the CRC kernel and no prefill
              the flash kernel; first rwkv6 scaled down on the card against
              the CPU;
  serve_zamba2  zamba2_1p2b at its full config (38 Mamba2 layers, the
              shared attention block after each of 6 groups of 6; 1.10e9
              parameters): 4 x 1024 prompt tokens, as serve_rwkv6 — each
              prefill must launch the flash kernel exactly once a group (6)
              at (128, 1024, 64); first zamba2 scaled down with a tail;
  serve_whisper  whisper_small at its full config (12 + 12 layers; 0.24e9
              parameters): 4 requests of 1500 frames and 64 decoder tokens
              — each prefill must launch the flash kernel exactly 12 times
              at (48, 1500, 64) (the encoder, not causal) and 12 at (48, 64,
              64) (the decoder); the cross-attention stays plain; first
              whisper scaled down on the card against the CPU;
  each serve phase's parameters must number the family's exact count
  (``exact_param_count``);
  train       olmo_1b at its full widths and 8 of its 16 layers
              (``TRAIN_LAYERS``) trained by the port's trainer: 5 steps of
              4 x 2048 tokens with an Erda checkpoint of the whole train
              state (6.4 GB) after step 3, then a fresh trainer
              resumes from it (every shard CRC-verified on the card) and its
              losses must equal the uninterrupted run's; no flash launch;
              first one train step on the card against the CPU on small
              f32 configs, olmo_1b, local_global, pixtral, granite_moe and
              mixtral (loss with the MoE aux term, and every gradient);
              last the checkpoint restored again by
              ``launch.elastic.reshard_restore`` onto a 1 x 1 DeviceMesh of
              the card (NCCL, world 1): every leaf bit-equal to the plain
              restore's, the CRC kernel launched, and the loss on the
              DTensor parameters equal to the plain one (rel 1e-4);
  dryrun      in subprocesses, on the CPU (fake tensors, a fake process
              group): ``launch.dryrun``'s record of olmo_1b x train_4k on
              the 16 x 16 production mesh, and the train phase's own step
              counted on a 1-GPU mesh, its H100 roofline terms beside the
              train phase's measured median step (``measured_over_roofline``);
  trace_check (not run by default) the profiler's lost device events at
              a session's start after the card idled, with and without the
              burst of throwaway kernels every profiled session begins with;
  kernels     a ``traces`` line (profiler sessions opened and each one
              thrown away for a lost marker), then one JSON line with an
              entry per ported kernel: launches on
              the main paths, agreement with the plain version, time beside
              its bound, the plain version's and the library call's; the
              CRC entry also at the DES phases' batches, with a verify
              call's host round trip beside zlib.
The last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM peaks (NVIDIA data sheet; one source, ``launch.mesh``): HBM
#: bytes/s, float32 operations/s outside the tensor cores — the rate the
#: CRC's integer steps and float32 attention are held to — and dense bf16
#: tensor-core operations/s
from repro_torch.launch.mesh import CUDA_CORE_FLOPS_F32 as CUDA_CORE_OPS_PER_S  # noqa: E402
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_TENSOR_OPS_PER_S  # noqa: E402
#: integer operations a CRC byte needs by the byte-table recurrence (xor,
#: and, table load, shift, xor); the kernel's slice-by-16 does about 3, and
#: either way the bytes bound it
CRC_OPS_PER_BYTE = 5
#: widest CRC batch (32-bit words a row) the kernels line holds against the
#: plain version: a (642, 16401) KV restore batch takes it ~4 s on the card
PLAIN_CRC_WORDS = 1 << 17
#: the serve restore's CRC batch: 3 cache leaves of 96 MiB (+ 12 bytes of
#: record header, in words) on one page-store shard
SERVE_RESTORE_CRC = (3, 25165843)
#: the serve_gemma3 restore's larger CRC batch: rows padded to the
#: ['local']['k'] leaf (209,715,200 B) and its headers, in words.  How many
#: rows a shard's batch has follows the page keys' routing, which Python
#: salts per process (6 and 4 in one run)
GEMMA3_RESTORE_CRC = (6, 52428820)
#: ... of serve_granite_moe: rows padded to the k leaf (150,994,944 B; 1
#: and 3 rows a shard in one run)
GRANITE_RESTORE_CRC = (3, 37748755)
#: ... of serve_gemma3_12b: rows padded to the ['local']['k'] leaf
#: (167,772,160 B; 2 and 5 rows a shard in one run)
GEMMA3_12B_RESTORE_CRC = (5, 41943060)
#: ... of serve_rwkv6, serve_zamba2 and serve_whisper: rows padded to the
#: ['layers']['tm']['h'] leaf (50,331,648 B), ['ssm_main']['h'] (150,994,944
#: B) and ['cross']['k'] (110,592,000 B); as many rows as the cache has
#: leaves (4, 8, 6), the most one shard's batch can hold
RWKV6_RESTORE_CRC = (4, 12582931)
ZAMBA2_RESTORE_CRC = (8, 37748755)
WHISPER_RESTORE_CRC = (6, 27648019)

#: the DES phases.  The paper's scheme comparison (§5.1): one cold read and
#: one update of each scheme at these value sizes, over ``SimTransport``,
#: whose simulated mean read latency must lie within ``ANCHOR_TOL_US`` of
#: the paper's (62.84 / 92.7 µs; the bounds of tests/test_fabric.py)
ANCHOR_SIZES = (16, 64, 256, 1024, 4096)
ANCHOR_READ_US = {"erda": 62.0, "redo": 92.0, "raw": 92.0}
ANCHOR_TOL_US = 4.0
#: ... and the NVM bytes of a create, an update and a delete at these sizes
#: must equal Table 1's formulas (Erda's with its record framing)
TABLE1_SIZES = (64, 1024)
#: YCSB's core workloads A-C (workloada-workloadc: read share 0.5 / 0.95 /
#: 1.0, Zipfian theta 0.99, 10 fields x 100 B records, here 1 KiB values):
#: 10,000 keys (10 MB of live values) and 20,000 ops a run on a 4-shard
#: erda-cluster, replayed by 16 contended threads; unbatched, and ycsb_b
#: also at batch 16.  The key count is cut by the host DES's speed (5-8 s a
#: run of the JAX package at this size)
YCSB = dict(n_keys=10_000, n_ops=20_000, value_size=1024, threads=16, n_shards=4)
YCSB_RUNS = (("ycsb_a", 0), ("ycsb_b", 0), ("ycsb_c", 0), ("ycsb_b", 16))
#: a YCSB shard: its 2,500 keys and every version a run writes
YCSB_SHARD = dict(device_size=64 << 20, table_capacity=1 << 13, n_heads=2,
                  region_size=2 << 20, segment_size=64 << 10)
#: the DES capture geometry (benchmarks/schemes_des.py's): traces depend on
#: verb sizes, not on capacity
CAPTURE_SHARD = dict(device_size=8 << 20, table_capacity=1 << 10, n_heads=1,
                     region_size=1 << 20, segment_size=64 << 10)
#: the fault workloads' shards (tests/test_replication.py's); the chaos
#: run's have quarter-size regions, since every heal and promotion scans
#: each head's regions on the host, 8 bytes a step
FAULT_SHARD = dict(device_size=16 << 20, table_capacity=1 << 10, n_heads=2,
                   region_size=1 << 20, segment_size=32 << 10)
CHAOS_SHARD = dict(FAULT_SHARD, device_size=8 << 20, region_size=256 << 10)
#: the kill-a-shard run of tests/test_replication.py
FAILOVER = dict(workload="ycsb_a", n_ops=600, n_keys=80, value_size=64, seed=3)
#: examples/serve_kv.py's KV page serving at load: 8 clients on 2 shards for
#: 20 ms at a 0.9 read share, per-op and coalesced doorbells; and 16 clients
#: on 4 shards for 6 ms with shared-QP coalescing under a 250 us SLO
AT_LOAD = dict(n_clients=8, n_shards=2, horizon_s=0.02, read_frac=0.9)
AT_LOAD_KOPS = (120.0, 900.0)
AT_LOAD_SLO = dict(n_clients=16, n_shards=4, horizon_s=0.006, read_frac=0.9,
                   seed=3, share_qp=True, b_max=64, slo_us=250.0,
                   capture_batches=(1, 2, 4, 8, 16, 32, 64))
AT_LOAD_SLO_KOPS = (400.0, 3840.0)
#: one KV head's 16-token block of olmo_1b: 16 x head_dim 128 x K and V x
#: bf16, the default block of paged KV caches
PAGE_VSIZE = 8192

#: the CRC rows the kernels line reports beside the main batch: a 1 KiB
#: YCSB record and an 8 KiB KV page, in 32-bit words (the value and 19 B of
#: record header and key, core/layout.py, in whole words)
RECORD_OVERHEAD = 19
DES_CRC_WIDTHS = tuple(-(-(v + RECORD_OVERHEAD) // 4) for v in (1024, PAGE_VSIZE))

#: a serve phase's limit on peak device memory (the card's 80 GB)
PEAK_BYTES_LIMIT = 80e9

#: the train phase's tolerance on resumed losses (the reference's, in
#: tests/test_checkpoint.py) and on card-vs-CPU gradients (its model check)
RESUME_REL = 1e-4
GRAD_TOL = 3e-5

#: the flash launches one serve_gemma3 prefill makes: one a global layer
GEMMA3_PREFILL_FLASH = {(32, 1536, 128, "bfloat16"): 10}
#: ... one serve_gemma3_12b prefill: 8 global layers, 16 heads of 256
GEMMA3_12B_PREFILL_FLASH = {(16, 1536, 256, "bfloat16"): 8}
#: ... one serve_granite_moe prefill: every layer, 4 requests x 24 heads
GRANITE_PREFILL_FLASH = {(96, 1024, 64, "bfloat16"): 32}
#: ... one serve_rwkv6 prefill: none, rwkv6 has no attention
RWKV6_PREFILL_FLASH = {}
#: ... one serve_zamba2 prefill: the shared block once a group (6), 4
#: requests x 32 heads; the 2 tail layers have no attention
ZAMBA2_PREFILL_FLASH = {(128, 1024, 64, "bfloat16"): 6}
#: ... one serve_whisper prefill: the 12 encoder layers over 1500 frames,
#: not causal, and the 12 decoder self-attentions over 64 tokens, 4
#: requests x 12 heads; the 12 cross-attentions (64 queries, 1500 keys)
#: stay plain
WHISPER_PREFILL_FLASH = {(48, 1500, 64, "bfloat16"): 12, (48, 64, 64, "bfloat16"): 12}
#: launch keys of a main path whose attention is not causal (a launch key
#: has no mask): whisper's encoder
NON_CAUSAL_FLASH = {(48, 1500, 64, "bfloat16")}
#: granite_moe_3b scaled down with top-8 of 16 experts in groups of 16, so
#: k = 8 and several dispatch groups a row run on the card
GRANITE_K8 = {"n_experts": 16, "n_experts_active": 8, "moe_group": 16}
#: the largest gate gap a routing flip between the card and the CPU may have
#: (a near tie: the two packages' float32 gates differ by ~1e-7)
NEAR_TIE = 1e-6
#: the most (routing call, token) pairs a model or train check lets flip
MAX_FLIPS = 8
#: the small f32 configs on which the model and train checks hold the card
#: to the CPU.  local_global at 8 layers has gemma3's two-layer tail, and
#: 160 tokens pass its 64-token window; pixtral prepends 8 patches
LOCAL_GLOBAL = dict(arch="gemma3_27b", overrides={"n_layers": 8})
MODEL_CHECKS = {"olmo_1b": dict(arch="olmo_1b", prompt_len=64),
                "local_global": dict(LOCAL_GLOBAL, prompt_len=160),
                "pixtral": dict(arch="pixtral_12b", prompt_len=24),
                "granite_moe": dict(arch="granite_moe_3b", overrides=GRANITE_K8,
                                    prompt_len=64),
                "mixtral": dict(arch="mixtral_8x22b", prompt_len=100),
                "gemma3_12b": dict(arch="gemma3_12b",
                                   overrides={"head_dim": 256, "n_layers": 8},
                                   prompt_len=160),
                # 40 tokens: the WKV and SSD chunks halve from 16 to 8
                "rwkv6": dict(arch="rwkv6_1p6b", prompt_len=40),
                # zamba2 with a tail: 2 groups of 2 ssm layers, then 1
                "zamba2": dict(arch="zamba2_1p2b",
                               overrides={"n_layers": 5, "shared_attn_every": 2},
                               prompt_len=40),
                "whisper": dict(arch="whisper_small", prompt_len=24)}
TRAIN_CHECKS = {"olmo_1b": dict(arch="olmo_1b", seqs=(64, 640)),
                "local_global": dict(LOCAL_GLOBAL, seqs=(160,)),
                "pixtral": dict(arch="pixtral_12b", seqs=(24,)),
                "granite_moe": dict(arch="granite_moe_3b", overrides=GRANITE_K8,
                                    seqs=(64,)),
                "mixtral": dict(arch="mixtral_8x22b", seqs=(100,))}

#: olmo_1b widths (src/repro/configs/olmo_1b.py)
OLMO_1B = dict(d_model=2048, n_kv_heads=16, head_dim=128, d_ff=8192,
               vocab=50304, n_layers=16)

#: flash-attention shapes: (BH, S, hd), dtype, causal.  The first is the
#: serve phase's prefill (4 requests x 16 heads, 256 tokens); (32, 2048, 128)
#: is olmo_1b's full context; (32, 1536, 128) a gemma3_27b global layer in
#: the serve_gemma3 prefill (1 request x 32 heads, KV repeated 16 -> 32);
#: S = 64, 65, 100 hold the bf16 kernel's 64-key tile edge and ragged tail
#: against the plain version; (96, 1024, 64) is a serve_granite_moe prefill
#: layer (4 requests x 24 heads), (16, 1536, 256) a serve_gemma3_12b global
#: layer, and the other hd-256 rows its tile edge, a ragged non-causal tail
#: and the CUDA-core route; the last three a serve_zamba2 shared block, a
#: serve_whisper encoder layer (not causal, ragged: 1500 = 23 x 64 + 28)
#: and a serve_whisper decoder self-attention
FLASH_SHAPES = [((64, 256, 128), "bfloat16", True),
                ((64, 512, 128), "bfloat16", True),
                ((32, 2048, 128), "bfloat16", True),
                ((32, 1536, 128), "bfloat16", True),
                ((16, 64, 128), "bfloat16", True),
                ((16, 65, 128), "bfloat16", True),
                ((16, 100, 128), "bfloat16", False),
                ((3, 192, 32), "float32", True),
                ((2, 128, 64), "float32", False),
                ((96, 1024, 64), "bfloat16", True),
                ((16, 1536, 256), "bfloat16", True),
                ((16, 65, 256), "bfloat16", True),
                ((16, 100, 256), "bfloat16", False),
                ((3, 192, 256), "float32", True),
                ((128, 1024, 64), "bfloat16", True),
                ((48, 1500, 64), "bfloat16", False),
                ((48, 64, 64), "bfloat16", True)]
#: max |kernel - plain| allowed, by dtype (the reference's tolerances)
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}


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


#: throwaway kernels each profiler session launches (and waits for) as it
#: begins.  Once the card has idled for a few seconds, the traces of later
#: sessions lack their first device events (about a dozen on the H100 with
#: torch 2.11), however long the session waits before its work: these
#: kernels absorb the loss (``trace_check`` measures it; PERF.md section 7)
TRACE_BURST = 256
#: host seconds each profiler session waits after the burst and after the
#: work: the burst then lies well before the first marker on the card's clock
TRACE_PAD_S = 0.25
#: name and cycles of the spin kernel (``torch.cuda._sleep``) launched just
#: before and just after the traced work
MARK_KERNEL = "spin_kernel"
MARK_CYCLES = 1000
#: profiler sessions ``traced`` opens at most for one measurement: a trace
#: that lost a marker is thrown away and the work traced again
TRACE_ATTEMPTS = 3
#: every session ``traced`` opened (``sessions``), and each one it threw
#: away: the markers it kept and which of them (``"first"``, ``"last"``)
TRACES = {"sessions": 0, "lost": []}


def device_events(prof) -> list:
    import torch
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def trace_session(fn, burst: int = TRACE_BURST) -> tuple:
    """(``torch.profiler`` trace, ``fn()``, markers the trace kept) of one
    call of ``fn`` between two spin kernels on the current stream, after a
    ``burst`` of throwaway kernels and ``TRACE_PAD_S`` seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sink = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(burst):
            sink.add_(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        torch.cuda._sleep(MARK_CYCLES)
        out = fn()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    marks = sum(MARK_KERNEL in e.name for e in device_events(prof))
    return prof, out, marks


def kept_marker(prof) -> str:
    """Which marker a trace that kept one of them kept: ``"first"`` if a
    device event (the work's) began after it, else ``"last"``."""
    device = device_events(prof)
    mark = next(e.time_range.start for e in device if MARK_KERNEL in e.name)
    return "first" if any(e.time_range.start > mark for e in device) else "last"


def traced(fn):
    """(``trace_session`` trace, ``fn()``) of a session that kept both
    markers: the stream runs them in order around ``fn``'s kernels, so a
    trace that lost the device events of the work's first (or last)
    milliseconds lost a marker.  Such a trace is logged in ``TRACES`` and
    ``fn`` runs again in a new session; raises after ``TRACE_ATTEMPTS``
    lost traces."""
    for _ in range(TRACE_ATTEMPTS):
        TRACES["sessions"] += 1
        prof, out, marks = trace_session(fn)
        if marks == 2:
            return prof, out
        TRACES["lost"].append({"session": TRACES["sessions"], "marks_kept": marks,
                               "kept": kept_marker(prof) if marks == 1 else None})
    check(False, f"{TRACE_ATTEMPTS} profiler traces in a row lost device events: "
          f"{TRACES['lost'][-TRACE_ATTEMPTS:]}")


def traced_work(prof) -> list:
    """The device events (kernels, copies) of a ``traced`` trace from its
    first marker on, the markers left out: the work's, not the burst's."""
    device = device_events(prof)
    first = min(e.time_range.start for e in device if MARK_KERNEL in e.name)
    return [e for e in device if MARK_KERNEL not in e.name and e.time_range.start >= first]


def traced_device_ms(prof, name: str = "") -> float:
    """Summed device time (ms) of the work's kernels and copies in a
    ``traced`` trace; only those whose name holds ``name``, where given."""
    return sum(e.time_range.elapsed_us() for e in traced_work(prof) if name in e.name) / 1e3


def run_trace_check(dev, *, rounds: int = 8, idle_s: float = 5.0) -> dict:
    """The profiler's loss at a session's start, beside every path: each
    round the card idles ``idle_s`` seconds, then one session without the
    burst and one with ``TRACE_BURST`` (in turn first) trace the same 20 CRC
    launches; counts the sessions of each kind that lost a marker."""
    from repro_torch.kernels import ops
    data = random_words((1, 261), seed=0, dev=dev)
    work = lambda: [ops.crc32_batch(data) for _ in range(20)]
    work()
    kinds = [("without_burst", 0), ("with_burst", TRACE_BURST)]
    lost = {kind: 0 for kind, _ in kinds}
    for r in range(rounds):
        time.sleep(idle_s)
        for kind, burst in kinds[r % 2:] + kinds[:r % 2]:
            lost[kind] += trace_session(work, burst)[2] != 2
    return {"rounds": rounds, "idle_s": idle_s, "lost": lost}


def profiled_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call, from a ``traced`` session of ``reps``
    calls after one warm-up: the work of the kernels it launches, without
    the host's cost of launching them (which ``cuda_ms`` counts whenever
    the host is slower than the card)."""
    import torch
    fn()
    torch.cuda.synchronize()
    prof, _ = traced(lambda: [fn() for _ in range(reps)])
    ms = traced_device_ms(prof)
    check(ms > 0, "the profiler's trace holds no device time")
    return ms / reps


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


def flash_bound_ms(bh: int, s: int, hd: int, dtype: str, causal: bool) -> tuple:
    """The least time the card could take for one flash-attention call: q,
    k, v read once and o written once over HBM, against 4*BH*S^2*hd
    operations (half when causal) over the tensor cores' bf16 rate or the
    CUDA cores' float32 rate.  Returns (ms, "bytes" | "operations")."""
    elt = 2 if dtype == "bfloat16" else 4
    t_bytes = 4 * bh * s * hd * elt / HBM_BYTES_PER_S
    ops = 4 * bh * s * s * hd / (2 if causal else 1)
    t_ops = ops / (BF16_TENSOR_OPS_PER_S if dtype == "bfloat16"
                   else CUDA_CORE_OPS_PER_S)
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
    # registers and shared memory ("ptxas info"), stack and spills
    ptxas = [ln.strip() for log in build.BUILD_LOG.values()
             for ln in log.splitlines() if "ptxas info" in ln or "spill" in ln]
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "build_s": build_s, "ptxas": ptxas}
    emit("device", **info)
    return info


def crc_case(n: int, w: int, seed: int, dev, *, plain: bool = True) -> dict:
    """The CRC kernel through its wrapper (``ops.crc32_batch``; on the CPU,
    the plain version) on random (n, w) words, exactly against host zlib
    and, where ``plain``, the plain version; on the card also the device
    time of the kernel and of the plain version."""
    from repro_torch.kernels import ops, ref
    data = random_words((n, w), seed=seed, dev=dev)
    got = ops.crc32_batch(data)
    t0 = time.perf_counter()
    want = zlib_rows(data)
    zlib_ms = (time.perf_counter() - t0) * 1e3
    check(got.cpu().tolist() == want, f"crc32 kernel != zlib at {(n, w)}")
    if plain:
        check(bool((got == ref.crc32_ref(data)).all()),
              f"crc32 kernel != plain at {(n, w)}")
    bound, by = crc_bound_ms(n, w)
    out = {"shape": [n, w], "exact": True, "zlib_ms": zlib_ms,
           "bound_ms": bound, "bound_by": by, "ms": None, "plain_ms": None}
    if dev.type == "cuda":
        out["ms"] = profiled_ms(lambda: ops.crc32_batch(data), 10)
        if plain:
            out["plain_ms"] = cuda_ms(lambda: ref.crc32_ref(data), 1)
    return out


def phase_crc32(dev, shapes=None, *, long=(120, 1048581),
                serve=(SERVE_RESTORE_CRC, GEMMA3_RESTORE_CRC, GRANITE_RESTORE_CRC,
                       GEMMA3_12B_RESTORE_CRC, RWKV6_RESTORE_CRC, ZAMBA2_RESTORE_CRC,
                       WHISPER_RESTORE_CRC)) -> list:
    """Kernel vs plain version vs zlib, exactly, at the listed shapes (the
    chunk-boundary widths among them); then 4 MiB records (a checkpoint
    shard) and the batches of every serve phase's restore against zlib
    only — the plain version's per-byte loop would take minutes to hours at
    those widths."""
    from repro_torch.kernels.crc32 import CHUNK_UNITS
    c = 4 * CHUNK_UNITS  # words of one chunk of the kernel's first pass
    shapes = shapes or [(1, 1), (1000, 3), (512, 256), (2048, 16400),
                        (7, c - 1), (7, c), (7, c + 1)]
    out = [crc_case(n, w, seed=i, dev=dev) for i, (n, w) in enumerate(shapes)]
    return out + [crc_case(n, w, seed=99 + i, dev=dev, plain=False)
                  for i, (n, w) in enumerate((long, *serve))]


def flash_case(shape, dtype: str, causal: bool, seed: int, dev) -> dict:
    """The flash kernel through its wrapper (``ops.flash_attention``; on the
    CPU, the plain version) against ``ref.attention_ref`` on the same random
    (BH, S, hd) inputs; on the card also the device time of the kernel, the
    plain version and SDPA, and the time of a wrapper call as a caller sees
    it (``call_ms``, host launch cost included).  Raises when the error
    exceeds the dtype's tolerance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, dtype=getattr(torch, dtype),
                           device=dev) for _ in range(3))
    # (BH, S, hd) passed as (1, S, BH, hd): the wrapper's fold is then a view
    as_bshd = lambda t: t[None].transpose(1, 2)
    kernel = lambda: ops.flash_attention(as_bshd(q), as_bshd(k), as_bshd(v),
                                         causal=causal)
    got = kernel().transpose(1, 2)[0]
    plain = ref.attention_ref(q, k, v, causal=causal)
    err = float((got.float() - plain.float()).abs().max().item())
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"flash output {tuple(got.shape)} {got.dtype} at {shape}")
    check(err <= FLASH_TOL[dtype],
          f"flash kernel != plain at {shape} {dtype} causal={causal}: {err}")
    bound, by = flash_bound_ms(*shape, dtype, causal)
    out = {"shape": list(shape), "dtype": dtype, "causal": causal,
           "max_abs_err": err, "tol": FLASH_TOL[dtype],
           "bound_ms": bound, "bound_by": by,
           "ms": None, "plain_ms": None, "library_ms": None, "call_ms": None}
    if dev.type == "cuda":
        sdpa = lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal)
        out.update(ms=profiled_ms(kernel, 20),
                   plain_ms=profiled_ms(lambda: ref.attention_ref(q, k, v, causal=causal), 3),
                   library_ms=profiled_ms(sdpa, 20),
                   call_ms=cuda_ms(kernel, 20))
    return out


def run_flash_attention(dev, shapes=FLASH_SHAPES) -> list:
    """One ``flash_case`` per shape; launches here are not the main path's."""
    return [flash_case(shape, dtype, causal, seed=i, dev=dev)
            for i, (shape, dtype, causal) in enumerate(shapes)]


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


def timed(fn, sink: list, dev):
    """``fn`` with the host time of each call, ending in a synchronise,
    appended to ``sink``."""
    def run(*args, **kwargs):
        ms, out = wall_ms(lambda: fn(*args, **kwargs), dev)
        sink.append(ms)
        return out
    return run


def busy_share(fn, dev, top: int = 0) -> dict:
    """Host time of one ``fn`` call in a ``traced`` session, and the share
    of it in which the card ran work: the device time of every kernel and
    copy in the trace over the host time (the profiler's own cost included).
    The share is None off the card.  ``top`` > 0 adds the device ms of the
    ``top`` costliest kernel names."""
    if dev.type != "cuda":
        return {"host_ms": wall_ms(fn, dev)[0], "device_ms": None, "busy_share": None}
    prof, (ms, _) = traced(lambda: wall_ms(fn, dev))
    device_ms = traced_device_ms(prof)
    check(device_ms > 0, "the profiler's trace holds no device time")
    out = {"host_ms": ms, "device_ms": device_ms, "busy_share": device_ms / ms}
    if top:  # kernels grouped by the first 90 characters of their names
        by_name = {}
        for e in traced_work(prof):
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
        out["top_kernels_ms"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return out


class RoutingLog:
    """While entered, every ``moe.route`` call's chosen experts, queue
    positions, keep-mask and float32 gates, in call order, on the CPU.

    With ``replay`` (another run's calls: the card's log), each call is held
    to that run's call of the same index: a token whose experts differ must
    be a near tie (``check_flip``), and such a call then routes as the other
    run did, with this run's gates at the other run's experts, so that both
    runs go on computing the same function on nearly the same inputs.
    ``flips`` lists the calls that flipped."""

    def __init__(self, replay=None):
        self.calls, self.replay, self.flips = [], replay, []

    def __enter__(self):
        import torch
        from repro_torch.models.layers import moe as M
        self._route = route = M.route

        def logged(params, x, cfg):
            r = route(params, x, cfg)
            xg = x.reshape(*r.topi.shape[:3], x.shape[-1]).float()
            gates = torch.softmax(xg.detach() @ params["router"].detach(), dim=-1)
            own = (r.topi.cpu(), r.pos.cpu(), r.keep.cpu(), gates.cpu())
            self.calls.append(own)
            if self.replay is None:
                return r
            i = len(self.calls) - 1
            check(i < len(self.replay),
                  f"routing call {i} past the other run's {len(self.replay)}")
            flip = routing_flip(self.replay[i], own)
            if flip is None:
                return r
            self.flips.append(check_flip(dict(flip, call=i), "routing"))
            topi, pos, keep = (t.to(x.device) for t in self.replay[i][:3])
            topv = torch.softmax(xg @ params["router"], dim=-1).gather(-1, topi)
            topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
            return M.Routing(r.g, r.C, topi, topv, pos, keep)
        M.route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models.layers import moe as M
        M.route = self._route

    def dropped(self) -> dict:
        """(token, expert) pairs over capacity, of all pairs routed."""
        pairs = sum(keep.numel() for _i, _p, keep, _g in self.calls)
        dropped = sum(int((~keep).sum()) for _i, _p, keep, _g in self.calls)
        return {"calls": len(self.calls), "pairs": pairs, "dropped": dropped,
                "dropped_share": dropped / pairs if pairs else None}


def routing_flip(card, cpu):
    """None when one routing call sent every token to the same experts on
    both runs, each (token, expert) pair with the same keep (the order of a
    token's experts does not matter); else the tokens whose experts differ,
    the largest gap between the CPU's gates of the experts either side chose
    there (None when no token's experts differ), and the groups whose keep
    differs although no token of theirs flipped: capacity follows the
    experts chosen, so those are faults."""
    import torch
    (ta, _pa, ka, _ga), (tb, _pb, kb, gb) = card, cpu

    def by_expert(topi, keep):  # (B, n, g, E): the pairs capacity kept
        return torch.zeros((*topi.shape[:-1], gb.shape[-1]),
                           dtype=torch.bool).scatter(-1, topi, keep)
    differ = (ta.sort(-1).values != tb.sort(-1).values).any(-1)    # (B, n, g)
    keep_differ = (by_expert(ta, ka) != by_expert(tb, kb)).any(-1).any(-1)
    stray = int((keep_differ & ~differ.any(-1)).sum())
    if not differ.any() and not stray:
        return None
    gap = None
    for idx in differ.nonzero().tolist():
        experts = sorted(set(ta[tuple(idx)].tolist()) ^ set(tb[tuple(idx)].tolist()))
        g = gb[tuple(idx)][experts]
        gap = max(gap or 0.0, float(g.max() - g.min()))
    return {"tokens": int(differ.sum()), "max_gate_gap": gap, "keep_faults": stray}


def check_flip(flip: dict, what: str) -> dict:
    """A routing flip passes only as a near tie: each token whose experts
    differ has the gates of those experts less than ``NEAR_TIE`` apart, and
    every keep difference lies in a group with such a token."""
    gap = flip["max_gate_gap"]
    check(gap is not None and gap < NEAR_TIE and not flip["keep_faults"],
          f"{what}: routing on the card != CPU and it is no near tie: {flip}")
    return flip


def check_routing(card: RoutingLog, cpu: RoutingLog, what: str) -> list:
    """The flips of ``cpu``, a replay of ``card`` (each a near tie, checked
    as it happened), after checking that both runs made the same routing
    calls and flipped at most ``MAX_FLIPS`` (call, token) pairs."""
    check(len(card.calls) == len(cpu.calls),
          f"{what}: {len(card.calls)} routing calls on the card, "
          f"{len(cpu.calls)} on the CPU")
    flipped = sum(f["tokens"] for f in cpu.flips)
    check(flipped <= MAX_FLIPS, f"{what}: {flipped} routed tokens flipped between "
          f"the card and the CPU, more than {MAX_FLIPS}: {cpu.flips}")
    return cpu.flips


def run_model_check(dev, *, arch: str = "olmo_1b", overrides=None, batch: int = 2,
                    prompt_len: int = 64, steps: int = 4) -> dict:
    """The model on ``dev`` against the CPU's plain path on the same weights
    (``arch``'s scaled-down config with ``overrides``, in float32, weights
    drawn on the CPU): prefill logits, every cache leaf and ``steps``
    decode steps' logits within 3e-5, the tolerance the CPU tests hold the
    port to against the JAX package.  A MoE config's CPU run replays the
    card's routing (``RoutingLog``): should the card route a token to other
    experts than the CPU, the check fails unless the flip is a near tie,
    the CPU then routes as the card did, every value is still compared, and
    the line lists the flips (``routing_flips``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.models import get_model
    from repro_torch.tree import flatten_with_path, map_leaves

    overrides = overrides or {}
    cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype="float32",
                              **overrides)
    cpu = torch.device("cpu")
    params = get_model(cfg, cpu).init(0)
    prompts = make_batch(cfg, ShapeConfig("check", prompt_len, batch, "prefill"))
    worst = 0.0

    def close(a, b, what):
        nonlocal worst
        a, b = a.to(cpu), b.to(cpu)
        err = float((a.float() - b.float()).abs().max().item()) if a.numel() else 0.0
        worst = max(worst, err)
        check(a.shape == b.shape and bool(torch.allclose(a.float(), b.float(),
                                                         rtol=3e-5, atol=3e-5)),
              f"model on {dev} != CPU at {what}: max abs err {err}")

    with torch.inference_mode():
        runs, logs = [], []
        for d in (dev, cpu):
            model = get_model(cfg, d)
            p = map_leaves(lambda t: t.to(d), params)
            with RoutingLog(replay=logs[0].calls if logs else None) as log:
                logits, cache = model.prefill(p, prompts)
                outs = [(logits, cache)]
                for _ in range(steps):
                    token = torch.argmax(outs[0][0], dim=-1).to(torch.int32)
                    logits, cache = model.decode_step(p, cache, token)
                    outs.append((logits, cache))
            runs.append(outs)
            logs.append(log)
    flips = check_routing(*logs, f"model check {arch}")
    for i, ((la, ca), (lb, cb)) in enumerate(zip(*runs)):
        close(la, lb, f"step {i} logits")
        for (path, a), (_q, b) in zip(flatten_with_path(ca), flatten_with_path(cb)):
            close(a, b, f"step {i} cache {path}")
    return {"config": f"{arch} scaled_down float32 {overrides}",
            "attn_pattern": cfg.attn_pattern, "family": cfg.family, "batch": batch,
            "prompt_len": prompt_len, "decode_steps": steps,
            "moe_routing_calls": len(logs[1].calls), "routing_flips": flips,
            "max_abs_err": worst, "tol": 3e-5}


def run_serve(dev, *, cfg=None, batch: int = 4, prompt_len: int = 256,
              tokens: int = 16, snapshot_every: int = 8, crash_at: int = 10,
              seed: int = 0, flash_per_prefill=None, probe=None) -> dict:
    """The serving engine at ``cfg`` (default: olmo_1b at its full config):
    a clean run, then a run preempted after ``crash_at`` decode steps that
    restores its cache from the page store; each engine has its own page
    store (``launch.serve.page_store_for``).  The tokens must be equal, and
    on the card the prefill must have launched the flash kernel — exactly
    ``flash_per_prefill`` ({launch key: count}) a prefill where given — and
    the restore the CRC kernel, and the peak device memory must stay under
    ``PEAK_BYTES_LIMIT``.  ``probe(model, params, prompts)``, run
    before the main path, adds its dict to the result under "probe"."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import ROUTES, launches_by_route
    from repro_torch.launch.serve import page_store_for
    from repro_torch.models import get_model
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import flatten_with_path

    cfg = cfg or get_config("olmo_1b")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    model = get_model(cfg, dev)
    params = model.init(seed)
    n_params = sum(t.numel() for _p, t in flatten_with_path(params))
    prompts = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(
        cfg, ShapeConfig("serve", prompt_len, batch, "prefill")).items()}
    # warm-up outside the timed runs (library handles, kernel loads), then
    # one profiled prefill and decode step; the runs' prefill computes the
    # same logits from the same inputs
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompts)
        check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
        token = torch.argmax(logits, -1).to(torch.int32)
        model.decode_step(params, cache, token)
        busy = {"prefill": busy_share(lambda: model.prefill(params, prompts), dev, top=8),
                "decode_step": busy_share(
                    lambda: model.decode_step(params, cache, token), dev, top=8)}
        leaf_bytes, leaf_path = max(((t.numel() * t.element_size(), p)
                                     for p, t in flatten_with_path(cache)),
                                    key=lambda leaf: leaf[0])
        del logits, cache
        probed = probe(model, params, prompts) if probe else None

    names = ("prefill_ms", "decode_ms", "snapshot_ms", "restore_ms")
    times = {run: {n: [] for n in names} for run in ("clean", "preempted")}
    geometry = {}

    def engine(sinks):
        pages = page_store_for(cfg, batch, prompt_len, tokens, snapshot_every, dev)
        shard = pages.store.cluster.cfg
        geometry.update(n_shards=len(pages.store.cluster.groups),
                        device_size=shard.device_size,
                        segment_size=shard.segment_size, n_heads=shard.n_heads)
        eng = ServeEngine(model, params, snapshot_every=snapshot_every, device=dev,
                          page_store=pages)
        eng._prefill = timed(eng._prefill, sinks["prefill_ms"], dev)
        eng._decode = timed(eng._decode, sinks["decode_ms"], dev)
        eng.pages.snapshot_cache = timed(eng.pages.snapshot_cache,
                                         sinks["snapshot_ms"], dev)
        eng.pages.restore_cache = timed(eng.pages.restore_cache,
                                        sinks["restore_ms"], dev)
        return eng

    ops.reset_counts()  # the main path starts here
    clean = engine(times["clean"]).generate(prompts, tokens, seq_id=0)
    preempted = engine(times["preempted"]).generate(prompts, tokens, seq_id=0,
                                                    crash_at=crash_at)
    flash, crc = ops.COUNTS["flash_attention"], ops.COUNTS["crc32_batch"]
    check(clean.shape == (batch, tokens), f"clean tokens {clean.shape}")
    check(bool(((clean >= 0) & (clean < cfg.vocab_size)).all()),
          "a token outside the vocabulary")
    check(np.array_equal(clean, preempted), "preempted tokens != clean tokens")
    check(len(times["preempted"]["restore_ms"]) == 1, "no restore ran")
    check(dev.type == "cpu" or flash.launches > 0 or flash_per_prefill == {},
          "serve launched no flash kernel")
    routes = launches_by_route(flash.shapes)
    want_route = ROUTES[cfg.dtype]
    check(all(n == 0 for r, n in routes.items() if r != want_route),
          f"the {cfg.dtype} prefill took another flash route: {routes}")
    check(dev.type == "cpu" or crc.launches > 0, "restore launched no CRC kernel")
    prefills = len(times["clean"]["prefill_ms"]) + len(times["preempted"]["prefill_ms"])
    if cuda and flash_per_prefill is not None:
        want = {k: n * prefills for k, n in flash_per_prefill.items()}
        check(dict(flash.shapes) == want,
              f"flash launches {dict(flash.shapes)} over {prefills} prefills, want {want}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    check(peak is None or peak < PEAK_BYTES_LIMIT,
          f"peak device memory {peak} B, not under {PEAK_BYTES_LIMIT}")
    mean = lambda xs: sum(xs) / len(xs)
    out = {"config": cfg.name, "params": n_params, "dtype": cfg.dtype,
           "attn_pattern": cfg.attn_pattern, "window": cfg.window,
           "batch": batch, "prompt_len": prompt_len, "tokens": tokens,
           "snapshot_every": snapshot_every, "crash_at": crash_at,
           "largest_cache_leaf_bytes": leaf_bytes, "largest_cache_leaf": leaf_path,
           "page_store": geometry, "tokens_equal": True, "prefills": prefills,
           "first_tokens": clean[0].tolist(), "profiled": busy, "probe": probed,
           "max_memory_allocated": peak}
    for run, t in times.items():
        out[run] = {"prefill_ms": t["prefill_ms"][0],
                    "decode_ms_per_token": mean(t["decode_ms"]),
                    "decode_steps": len(t["decode_ms"]),
                    "snapshot_ms": mean(t["snapshot_ms"]),
                    "snapshots": len(t["snapshot_ms"]),
                    "restore_ms": t["restore_ms"][0] if t["restore_ms"] else None}
    for name, count in (("flash_attention", flash), ("crc32_batch", crc)):
        out[name] = {"launches": count.launches,
                     "shapes": {str(k): v for k, v in count.shapes.items()}}
    out["flash_attention"]["by_route"] = routes
    return out


def exact_param_count(cfg, max_seq: int = 4096) -> int:
    """The parameter elements ``get_model(cfg).init(max_seq=max_seq)``
    makes, in closed form.  ``ModelConfig.param_count`` is exact for the
    transformer's families but for the norms' scales (two a layer, one
    final); for the others it is approximate, so they are counted here:
      ssm (rwkv6)   a layer: ln1, ln2; the time mix's 5 d x d, the decay
                    LoRA (d x 64, 64 x d), 5 shift mixes, w0, u (H x hd = d)
                    and its output norm; the channel mix's 2 shift mixes,
                    d x d, d x f, f x d; plus ln_in and the final norm;
      hybrid        an ssm layer: its norm, in_proj d x (2 di + 2 ds + nh),
                    the conv (K, di + 2 ds), A_log, D, dt_bias (nh each),
                    out_proj di x d, gate_norm di; one shared block (two
                    norms, attention, MLP) and the final norm;
      encdec        an encoder layer: 2 norms, attention, MLP; a decoder
                    layer: 3 norms, self- and cross-attention, MLP; dec_pos
                    (max_seq x d), the encoder's and the final norm.
    The embedding is V x d, twice when untied."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    nrm = d if cfg.norm != "nonparam_ln" else 0
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
    mlp = (3 if cfg.mlp_kind == "swiglu" else 2) * d * f
    if cfg.family == "ssm":
        layer = 2 * nrm + 6 * d * d + 2 * d * f + 2 * 64 * d + 10 * d
        return emb + 2 * nrm + L * layer
    if cfg.family == "hybrid":
        di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ssm = (nrm + d * (2 * di + 2 * ds + nh) + cfg.ssm_conv * (di + 2 * ds)
               + 3 * nh + di * d + di)
        return emb + nrm + L * ssm + 2 * nrm + attn + mlp
    if cfg.family == "encdec":
        enc, dec = 2 * nrm + attn + mlp, 3 * nrm + 2 * attn + mlp
        return emb + max_seq * d + cfg.encoder_layers * enc + L * dec + 2 * nrm
    return cfg.param_count() + (2 * L + 1) * nrm


def run_serve_full(dev, arch: str, *, cfg=None, restore_crc_words=None,
                   **kwargs) -> dict:
    """``run_serve`` at ``arch``'s full config (default; else ``cfg``), whose
    parameters must number ``exact_param_count``; on the card at the full
    config the widest restore CRC row must be ``restore_crc_words`` words
    where given."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    full = cfg is None
    cfg = cfg or get_config(arch)
    out = run_serve(dev, cfg=cfg, **kwargs)
    if dev.type == "cuda" and full and restore_crc_words:
        # the crc32 phase holds the kernel to zlib at this width
        widest = max(w for _n, w in ops.COUNTS["crc32_batch"].shapes)
        check(widest == restore_crc_words,
              f"restore CRC rows of {widest} words, the crc32 phase checks "
              f"{restore_crc_words}")
    exact = exact_param_count(cfg)
    check(out["params"] == exact, f"{out['params']} parameters, {exact} counted")
    return dict(out, config_param_count=cfg.param_count(), exact_param_count=exact)


def run_serve_gemma3(dev, *, cfg=None, prompt_len: int = 1536, **kwargs) -> dict:
    """gemma3_27b's full config (default), 1 request x ``prompt_len``
    tokens: every local layer runs banded attention, and on the card each
    prefill must launch the flash kernel exactly ``GEMMA3_PREFILL_FLASH``."""
    return run_serve_full(dev, "gemma3_27b", cfg=cfg, batch=1, prompt_len=prompt_len,
                          flash_per_prefill=GEMMA3_PREFILL_FLASH,
                          restore_crc_words=GEMMA3_RESTORE_CRC[1], **kwargs)


def run_serve_gemma3_12b(dev, *, cfg=None, prompt_len: int = 1536, **kwargs) -> dict:
    """gemma3_12b's full config (default; head_dim 256), 1 request x
    ``prompt_len`` tokens: on the card each prefill must launch the flash
    kernel exactly ``GEMMA3_12B_PREFILL_FLASH``, on the tensor-core route at
    head_dim 256, and the restore's widest CRC row is the crc32 phase's
    ``GEMMA3_12B_RESTORE_CRC`` width."""
    return run_serve_full(dev, "gemma3_12b", cfg=cfg, batch=1, prompt_len=prompt_len,
                          flash_per_prefill=GEMMA3_12B_PREFILL_FLASH,
                          restore_crc_words=GEMMA3_12B_RESTORE_CRC[1], **kwargs)


def moe_prefill_drops(model, params, prompts) -> dict:
    """One prefill with its routing logged: the (token, expert) pairs that
    capacity dropped, of all pairs, over every MoE layer, and the layers'
    group size and capacity."""
    import torch
    from repro_torch.models.layers import moe as M
    cfg = model.cfg
    with torch.inference_mode(), RoutingLog() as log:
        model.prefill(params, prompts)
    g = M.group_size(cfg, prompts["tokens"].shape[1])
    return dict(log.dropped(), group=g, capacity=M.capacity(cfg, g))


def run_serve_granite_moe(dev, *, cfg=None, batch: int = 4, prompt_len: int = 1024,
                          **kwargs) -> dict:
    """granite_moe_3b's full config (default), ``batch`` x ``prompt_len``
    tokens: on the card each prefill must launch the flash kernel exactly
    ``GRANITE_PREFILL_FLASH`` and the restore's widest CRC row is the crc32
    phase's ``GRANITE_RESTORE_CRC`` width; the probe counts the pairs a
    prefill's capacity drops."""
    return run_serve_full(dev, "granite_moe_3b", cfg=cfg, batch=batch,
                          prompt_len=prompt_len, flash_per_prefill=GRANITE_PREFILL_FLASH,
                          probe=moe_prefill_drops,
                          restore_crc_words=GRANITE_RESTORE_CRC[1], **kwargs)


def run_serve_rwkv6(dev, *, cfg=None, batch: int = 4, prompt_len: int = 1024,
                    **kwargs) -> dict:
    """rwkv6_1p6b's full config (default), ``batch`` x ``prompt_len``
    tokens: attention-free, so each prefill must launch the flash kernel no
    time; the restore's widest CRC row is ``RWKV6_RESTORE_CRC``'s width."""
    return run_serve_full(dev, "rwkv6_1p6b", cfg=cfg, batch=batch, prompt_len=prompt_len,
                          flash_per_prefill=RWKV6_PREFILL_FLASH,
                          restore_crc_words=RWKV6_RESTORE_CRC[1], **kwargs)


def run_serve_zamba2(dev, *, cfg=None, batch: int = 4, prompt_len: int = 1024,
                     **kwargs) -> dict:
    """zamba2_1p2b's full config (default: 6 groups of 6 Mamba2 layers and
    the shared block, a tail of 2), ``batch`` x ``prompt_len`` tokens: each
    prefill must launch the flash kernel exactly ``ZAMBA2_PREFILL_FLASH``;
    the restore's widest CRC row is ``ZAMBA2_RESTORE_CRC``'s width."""
    return run_serve_full(dev, "zamba2_1p2b", cfg=cfg, batch=batch, prompt_len=prompt_len,
                          flash_per_prefill=ZAMBA2_PREFILL_FLASH,
                          restore_crc_words=ZAMBA2_RESTORE_CRC[1], **kwargs)


def run_serve_whisper(dev, *, cfg=None, batch: int = 4, prompt_len: int = 64,
                      **kwargs) -> dict:
    """whisper_small's full config (default), ``batch`` requests of
    ``encoder_seq`` frames (1500: 30 s of audio, the stub frontend's) and
    ``prompt_len`` decoder tokens: each prefill must launch the flash
    kernel exactly ``WHISPER_PREFILL_FLASH`` (the encoder not causal); the
    restore's widest CRC row is ``WHISPER_RESTORE_CRC``'s width."""
    return run_serve_full(dev, "whisper_small", cfg=cfg, batch=batch,
                          prompt_len=prompt_len, flash_per_prefill=WHISPER_PREFILL_FLASH,
                          restore_crc_words=WHISPER_RESTORE_CRC[1], **kwargs)


def run_train_check(dev, *, arch: str = "olmo_1b", overrides=None, batch: int = 2,
                    seqs=(64, 640)) -> dict:
    """One train step on ``dev`` against the CPU on the same weights
    (``arch``'s scaled-down config with ``overrides``, in float32, every
    layer rematerialized as at the full config, weights drawn on the CPU):
    the loss and every gradient leaf within ``GRAD_TOL``, and the trainer
    step's loss and grad norm.  For olmo_1b S = 64 takes dense attention,
    640 chunked (5 KV chunks of 128); past a window, banded attention.  A
    MoE config's CPU run replays the card's routing as in
    ``run_model_check``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.launch.train import trainer_step
    from repro_torch.models import get_model
    from repro_torch.train.step import loss_and_grads, make_train_state
    from repro_torch.tree import flatten_with_path, map_leaves

    overrides = overrides or {}
    cfg = dataclasses.replace(get_config(arch).scaled_down(), dtype="float32",
                              remat="full", attn_chunk=128, **overrides)
    cpu = torch.device("cpu")
    state = make_train_state(get_model(cfg, cpu), 0)
    worst = 0.0

    def close(a, b, what):
        nonlocal worst
        a, b = a.to(cpu).float(), b.to(cpu).float()
        err = float((a - b).abs().max().item())
        worst = max(worst, err)
        check(a.shape == b.shape and bool(torch.allclose(a, b, rtol=GRAD_TOL,
                                                         atol=GRAD_TOL)),
              f"train step on {dev} != CPU at {what}: max abs err {err}")

    flips = []
    for seq in seqs:
        batch_np = make_batch(cfg, ShapeConfig("check", seq, batch, "train"))
        runs, logs = [], []
        for d in (dev, cpu):
            model = get_model(cfg, d)
            s = map_leaves(lambda t: t.to(d), state)
            batch_d = {k: torch.as_tensor(v, device=d) for k, v in batch_np.items()}
            with RoutingLog(replay=logs[0].calls if logs else None) as log:
                loss, grads = loss_and_grads(model.train_loss, s["params"], batch_d)
                _new, metrics = trainer_step(model, 3e-4, 10)(s, batch_d)
            runs.append((loss, grads, metrics))
            logs.append(log)
        flips += [dict(f, seq=seq) for f in
                  check_routing(*logs, f"train check {arch} S={seq}")]
        (la, ga, ma), (lb, gb, mb) = runs
        close(la, lb, f"S={seq} loss")
        close(ma["loss"], mb["loss"], f"S={seq} step loss")
        close(ma["grad_norm"], mb["grad_norm"], f"S={seq} grad norm")
        for (path, a), (_q, b) in zip(flatten_with_path(ga), flatten_with_path(gb)):
            close(a, b, f"S={seq} grad {path}")
    return {"config": f"{arch} scaled_down float32 remat=full attn_chunk=128 {overrides}",
            "attn_pattern": cfg.attn_pattern, "family": cfg.family,
            "batch": batch, "seqs": list(seqs), "routing_flips": flips,
            "max_abs_err": worst, "tol": GRAD_TOL}


#: layers of olmo_1b the train phase runs (of its 16; widths unchanged): the
#: whole script took more than 1000 s on the H100 at 16, so half the depth
#: (PERF.md section 4)
TRAIN_LAYERS = 8


def run_train(dev, *, cfg=None, batch: int = 4, seq: int = 2048, steps: int = 5,
              ckpt_at: int = 3, lr: float = 3e-4, seed: int = 0) -> dict:
    """The port's trainer (``launch.train``: its step, schedule, batches,
    checkpoint format and sized manager) at ``cfg`` (default: olmo_1b at its
    full widths and ``TRAIN_LAYERS`` layers): ``steps`` steps uninterrupted with a checkpoint after
    ``ckpt_at``, then a fresh trainer restores it and repeats the steps
    after it.  Fails unless every loss and grad norm is finite, the resumed
    losses equal the uninterrupted ones at ``RESUME_REL``, and on the card
    the restore launched the CRC kernel and the flash kernel launched no
    time (training's attention is the plain branch)."""
    import math
    import resource
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train.step import make_train_state
    from repro_torch.tree import flatten_with_path

    cfg = cfg or dataclasses.replace(get_config("olmo_1b"), n_layers=TRAIN_LAYERS)
    model = get_model(cfg, dev)
    step_fn = T.trainer_step(model, lr, steps)
    batches = [T.batch_at(cfg, seq, batch, s, dev) for s in range(steps)]
    state = make_train_state(model, seed)
    n_params = sum(t.numel() for _p, t in flatten_with_path(state["params"]))
    state_bytes = T.nbytes(state)
    mgr = T.checkpoint_manager_for(state_bytes, saves=1, device=dev)
    flash, crc = ops.COUNTS["flash_attention"], ops.COUNTS["crc32_batch"]
    cuda = dev.type == "cuda"

    ops.reset_counts()  # the main path starts here
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses, norms, step_ms = [], [], []
    save = {}
    for s in range(steps):
        ms, (state, metrics) = wall_ms(lambda: step_fn(state, batches[s]), dev)
        step_ms.append(ms)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if s + 1 == ckpt_at:
            save["ms"], save["shards"] = wall_ms(
                lambda: T.save_train_state(mgr, s + 1, state), dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    check(all(math.isfinite(x) for x in losses + norms),
          f"a loss or grad norm is not finite: {losses} {norms}")

    # outside the compared runs: the optimizer update alone (the state's
    # parameters stand in for gradients of their shape and dtype) and one
    # profiled step
    opt_cfg = AdamWConfig(lr=lr)
    update = lambda: adamw_update(opt_cfg, state["params"], state["params"], state["opt"])
    opt_ms = cuda_ms(update, 3) if cuda else wall_ms(update, dev)[0]
    busy = busy_share(lambda: step_fn(state, batches[-1]), dev, top=8)
    del state

    # a fresh trainer resumes from the store
    model = get_model(cfg, dev)
    step_fn = T.trainer_step(model, lr, steps)
    launches0, shapes0 = crc.launches, dict(crc.shapes)
    restore_ms, (start, state) = wall_ms(
        lambda: T.restore_train_state(mgr, model), dev)
    restore_shapes = {str(k): n - shapes0.get(k, 0) for k, n in crc.shapes.items()
                      if n != shapes0.get(k, 0)}
    restore_launches = crc.launches - launches0
    check(start == ckpt_at, f"resumed at step {start}, want {ckpt_at}")
    check(int(state["opt"]["step"]) == ckpt_at, "restored optimizer step")
    restored = state  # the plain restore, which the reshard must equal
    resumed, resumed_norms = [], []
    for s in range(start, steps):
        state, metrics = step_fn(state, batches[s])
        resumed.append(float(metrics["loss"]))
        resumed_norms.append(float(metrics["grad_norm"]))
    for a, b in zip(resumed, losses[start:]):
        check(abs(a - b) <= RESUME_REL * abs(b),
              f"resumed losses {resumed} != uninterrupted {losses[start:]}")
    check(all(math.isfinite(x) for x in resumed_norms), "a resumed grad norm is not finite")
    check(flash.launches == 0, f"training launched the flash kernel {flash.launches}x")
    check(not cuda or restore_launches > 0, "the restore launched no CRC kernel")
    del state
    reshard = run_reshard(mgr, model, restored, batches[ckpt_at], resumed[0], dev)
    del restored

    tokens = batch * seq
    median = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    flop = 6 * n_params * tokens
    flop_bound_ms = flop / BF16_TENSOR_OPS_PER_S * 1e3
    opt_bytes = 22 * n_params  # reads p, g (bf16), m, v; writes p, m, v
    opt_bound_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"config": cfg.name, "params": n_params, "dtype": cfg.dtype,
            "remat": cfg.remat, "layers": cfg.n_layers, "batch": batch, "seq": seq,
            "steps": steps, "ckpt_at": ckpt_at, "losses": losses, "grad_norms": norms,
            "resumed_losses": resumed, "resumed_grad_norms": resumed_norms,
            "resumed_bitwise_equal": resumed == losses[start:],
            "step_ms": step_ms, "step_ms_median_2_on": median,
            "tokens_per_s": tokens / (median / 1e3),
            "model_flop_per_step": flop, "flop_bound_ms": flop_bound_ms,
            "flop_share": flop_bound_ms / median,
            "opt_update_ms": opt_ms, "opt_bytes": opt_bytes,
            "opt_bound_ms": opt_bound_ms, "profiled_step": busy,
            "max_memory_allocated": peak, "state_bytes": state_bytes,
            # the process's peak resident host memory so far (Linux: KiB)
            "host_max_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "ckpt_servers": len(mgr.store.devs),
            "save_ms": save["ms"], "save_shards": save["shards"],
            "restore_ms": restore_ms, "restore_crc_launches": restore_launches,
            "restore_crc_shapes": restore_shapes,
            "flash_launches": flash.launches, "reshard": reshard}


def one_device_mesh(dev):
    """A (1, 1) ("data", "model") mesh of ``dev``: an NCCL group of one on
    the card (``launch.mesh.one_card_mesh``), a gloo group of one on the
    CPU.  The caller destroys the group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    if dev.type == "cuda":
        return M.one_card_mesh(dev)
    dist.init_process_group("gloo", rank=0, world_size=1, store=dist.HashStore())
    return M.make_test_mesh(data=1, model=1)


#: leaves whose placements the reshard prints
RESHARD_LEAVES = ("['params']['embed']['table']", "['params']['layers'][0]['attn']['wq']",
                  "['opt']['m']['layers'][0]['mlp']['wo']")


def run_reshard(mgr, model, plain, batch, plain_loss: float, dev) -> dict:
    """``launch.elastic.reshard_restore`` of the newest checkpoint in
    ``mgr`` (no new save) onto a 1 x 1 mesh of ``dev``: fails unless every
    leaf's full tensor is bit-equal to ``plain``'s (the plain restore), the
    restore launched the CRC kernel on the card, and ``train_loss`` on the
    DTensor parameters at ``batch`` equals ``plain_loss`` (the plain
    restore's loss there) within ``RESUME_REL``.  The process group goes
    when it is done."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels import ops
    from repro_torch.launch.elastic import reshard_restore
    from repro_torch.models.convert import to_reference_tree
    from repro_torch.train.step import make_train_state_abstract
    from repro_torch.tree import flatten_with_path

    crc = ops.COUNTS["crc32_batch"]
    mesh = one_device_mesh(dev)
    try:
        template = to_reference_tree(make_train_state_abstract(model))
        launches0, shapes0 = crc.launches, dict(crc.shapes)
        ms, (step, state) = wall_ms(
            lambda: reshard_restore(mgr, template, mesh, model.cfg.n_experts), dev)
        launches = crc.launches - launches0
        shapes = {str(k): n - shapes0.get(k, 0) for k, n in crc.shapes.items()
                  if n != shapes0.get(k, 0)}
        check(step is not None, "the reshard found no checkpoint")
        got, want = flatten_with_path(state), flatten_with_path(plain)
        check([p for p, _ in got] == [p for p, _ in want], "the reshard's tree differs")
        for (path, a), (_q, b) in zip(got, want):
            full = a.full_tensor() if isinstance(a, DTensor) else a
            check(full.dtype == b.dtype and bool(torch.equal(full, b)),
                  f"resharded {path} != the plain restore's")
        check(dev.type != "cuda" or launches > 0, "the reshard's restore launched no CRC kernel")
        with torch.no_grad(), implicit_replication():
            loss = model.train_loss(state["params"], batch)
        loss = float(loss.full_tensor() if isinstance(loss, DTensor) else loss)
        check(abs(loss - plain_loss) <= RESUME_REL * abs(plain_loss),
              f"loss on the resharded state {loss} != the plain restore's {plain_loss}")
        leaves = dict(got)
        return {"reshard_ms": ms, "step": step, "mesh": dict(zip(mesh.mesh_dim_names,
                                                                 mesh.shape)),
                "leaves_bit_equal": len(got), "crc_launches": launches,
                "crc_shapes": shapes, "loss": loss, "plain_loss": plain_loss,
                "loss_bitwise_equal": loss == plain_loss,
                "placements": {n: [repr(p) for p in leaves[n].placements]
                               for n in RESHARD_LEAVES}}
    finally:
        dist.destroy_process_group()


#: the dry-run phase's production cell: arch, shape, mesh (16 x 16, fake)
DRYRUN_CELL = ("olmo_1b", "train_4k", "single")


def dryrun_summary(rec: dict, step_ms=None) -> dict:
    """The roofline terms of a ``launch.dryrun`` record beside a measured
    step: ``measured_over_roofline`` is the step's time over the record's
    critical path (its largest term), None without a measured step."""
    crit = max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
    out = {k: rec[k] for k in ("arch", "shape", "mesh", "chips", "layers", "compute_s",
                               "memory_s", "collective_s", "dominant", "roofline_fraction",
                               "useful_fraction", "hlo_flops_total", "model_flops",
                               "collective_bytes_per_chip", "bytes_per_device", "lower_s")}
    out["roofline_ms"] = crit * 1e3
    out["measured_step_ms"] = step_ms
    out["measured_over_roofline"] = step_ms / (crit * 1e3) if step_ms and crit else None
    return out


def run_dryrun(dev, *, train=None, cell=DRYRUN_CELL, layers: int = TRAIN_LAYERS,
               batch: int = 4, seq: int = 2048, out_dir=None) -> dict:
    """``launch.dryrun`` in two subprocesses side by side (a fake process
    group must not share a process with NCCL; neither touches the card):
    ``cell``'s record on the fake production mesh, and the train phase's
    own step (olmo_1b at ``layers`` layers, ``batch`` x ``seq``, remat as
    configured) counted on a 1-GPU mesh, its terms beside ``train``'s
    measured median step.  Fails if either subprocess fails."""
    import os
    import tempfile
    root = Path(__file__).resolve().parent
    out = Path(out_dir or tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    arch, shape, mesh = cell
    one = ("from repro_torch.configs.base import ShapeConfig\n"
           "from repro_torch.launch.dryrun import run_cell\n"
           f"run_cell('olmo_1b', 'train_phase', 'one', {str(out)!r}, "
           f"{{'n_layers': {layers}}}, shape=ShapeConfig('train_phase', {seq}, {batch}, "
           "'train'))")
    cmds = {"cell": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                     "--shape", shape, "--mesh", mesh, "--out", str(out)],
            "train_phase": [sys.executable, "-c", one]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=root, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
    try:
        done = {k: (p.communicate(timeout=600), p.returncode) for k, p in procs.items()}
    finally:
        for p in procs.values():  # a failed phase leaves no process behind
            p.kill()
            p.wait()
    failed = {k: f"exit {rc}: {err[-3000:]}" for k, ((_out, err), rc) in done.items() if rc}
    check(not failed, f"dry-run subprocesses failed: {failed}")
    wall_s = time.perf_counter() - t0
    cell_rec = json.loads((out / f"{arch}__{shape}__{mesh}.json").read_text())
    train_rec = json.loads((out / "olmo_1b__train_phase__one.json").read_text())
    check(cell_rec["ok"] and train_rec["ok"], "a dry-run record is not ok")
    step_ms = (train or {}).get("step_ms_median_2_on")
    return {"wall_s": wall_s, "cell": cell_rec,
            "train_phase": dryrun_summary(train_rec, step_ms)}


# ------------------------------------------------------- the DES phases
def report_json(report) -> str:
    """A report as sorted JSON: keys as strings, tuples as lists, bytes as
    hex, anything else JSON lacks as its repr."""
    def canon(x):
        if isinstance(x, dict):
            return {str(k): canon(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [canon(v) for v in x]
        if isinstance(x, bytes):
            return x.hex()
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        return repr(x)
    return json.dumps(canon(report), sort_keys=True)


def sim_transports(p=None):
    """A ``transport_factory`` of DES-timed ``SimTransport``s."""
    from repro_torch.fabric import SimTransport
    from repro_torch.netsim import SimParams
    p = p or SimParams()
    return lambda nvm: SimTransport(nvm, p)


def erda_cluster(dev, shard: dict, *, sim: bool = True, **kwargs):
    """An erda-cluster whose clients verify on ``dev``, over SimTransport
    where ``sim``."""
    from repro_torch.core import ServerConfig, make_store
    if sim:
        kwargs["transport_factory"] = sim_transports()
    return make_store("erda-cluster", cfg=ServerConfig(**shard), device=dev, **kwargs)


def crc_launched(fn):
    """(``fn()``, the CRC launches it made, {shape: launches})."""
    from repro_torch.kernels import ops
    count = ops.COUNTS["crc32_batch"]
    launches0, shapes0 = count.launches, dict(count.shapes)
    out = fn()
    shapes = {k: n - shapes0.get(k, 0) for k, n in count.shapes.items()
              if n != shapes0.get(k, 0)}
    return out, count.launches - launches0, shapes


def uncounted(fn):
    """``fn()`` with its launches left out of every kernel's count: a
    measurement beside the main path, not part of it."""
    from repro_torch.kernels import ops
    saved = {name: (c.launches, c.rows, dict(c.shapes)) for name, c in ops.COUNTS.items()}
    try:
        return fn()
    finally:
        for name, c in ops.COUNTS.items():
            c.launches, c.rows, c.shapes = saved[name]


def crc_profile(fn, dev) -> dict:
    """One ``traced`` call of ``fn`` on the card: the CRC kernels' device ms
    (both passes) and launches, every kernel's and copy's device ms, the
    host ms and the busy share.  Off the card, the host ms only."""
    if dev.type != "cuda":
        return {"host_ms": wall_ms(fn, dev)[0], "crc_kernel_ms": None}
    prof, ((ms, _), launches, _shapes) = traced(lambda: crc_launched(lambda: wall_ms(fn, dev)))
    kernel_ms = traced_device_ms(prof, "crc32")
    device_ms = traced_device_ms(prof)
    check(kernel_ms > 0, "the profiled run's trace holds no CRC kernel time")
    return {"launches": launches, "crc_kernel_ms": kernel_ms,
            "crc_kernel_ms_per_launch": kernel_ms / launches, "device_ms": device_ms,
            "host_ms": ms, "busy_share": device_ms / ms}


def run_des_check(dev, *, n_keys: int = 400, n_ops: int = 2000, value_size: int = 64,
                  threads: int = 8, failover=FAILOVER, at_load_horizon_s: float = 0.004,
                  shard=YCSB_SHARD, fault_shard=FAULT_SHARD) -> dict:
    """The DES workloads with every Erda verify on ``dev`` against the same
    calls on the CPU (the plain CRC): ``run_store_workload`` on a 4-shard
    erda-cluster over SimTransport (ycsb_a at batch 16, ycsb_c unbatched,
    both replayed by ``threads`` contended threads), the kill-a-shard run
    and ``serve_kv_at_load`` at 120 and 900 KOp/s with its event trace.
    The DES is deterministic and the CRC verdict exact, so each pair of
    reports must be equal as sorted JSON, and each run on the card must
    have launched the CRC kernel."""
    import torch
    from repro_torch.serving import engine, event_trace_bytes
    from repro_torch.workloads import run_failover_workload, run_store_workload
    cpu = torch.device("cpu")

    def ycsb(workload, batch):
        return lambda d: run_store_workload(
            erda_cluster(d, shard, n_shards=4), workload, n_ops=n_ops, n_keys=n_keys,
            value_size=value_size, batch_size=batch, contended_threads=threads)

    def at_load(kops):
        def run(d):
            engine._page_traces.clear()  # each call captures on its own device
            return engine.serve_kv_at_load(kops, **dict(AT_LOAD, horizon_s=at_load_horizon_s),
                                           collect_trace=True, device=d)
        return run
    calls = {"ycsb_a_batch16": ycsb("ycsb_a", 16), "ycsb_c": ycsb("ycsb_c", 0),
             "failover": lambda d: run_failover_workload(
                 erda_cluster(d, fault_shard, sim=False, n_shards=4, replication=2),
                 **failover)}
    calls.update({f"at_load_{kops:g}": at_load(kops) for kops in AT_LOAD_KOPS})
    out = {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        card, launches, shapes = crc_launched(lambda: call(dev))
        t1 = time.perf_counter()
        plain = call(cpu)
        t2 = time.perf_counter()
        check(report_json(card) == report_json(plain),
              f"des_check {name}: the report on {dev} != the CPU's")
        if "event_trace" in card:
            check(event_trace_bytes(card) == event_trace_bytes(plain),
                  f"des_check {name}: event traces differ")
        check(dev.type == "cpu" or launches > 0, f"des_check {name}: no CRC launch on the card")
        out[name] = {"equal": True, "report_bytes": len(report_json(card)),
                     "crc_launches": launches,
                     "crc_shapes": {str(k): v for k, v in shapes.items()},
                     "card_s": t1 - t0, "cpu_s": t2 - t1}
    return out


def anchor_store(scheme: str, dev, *, sim: bool = True):
    """``scheme``'s store at the DES capture geometry (the baselines at
    their capture sizes); Erda verifies on ``dev``."""
    from repro_torch.core import ServerConfig, make_store
    kw = {"transport_factory": sim_transports()} if sim else {}
    if scheme == "erda":
        return make_store("erda", cfg=ServerConfig(**CAPTURE_SHARD), device=dev, **kw)
    if scheme == "redo":
        return make_store("redo", device_size=8 << 20, redo_capacity=1 << 20, **kw)
    return make_store("raw", device_size=8 << 20, ring_capacity=1 << 20, **kw)


def capture_op_steps(scheme: str, vsize: int, dev) -> dict:
    """The DES steps of one cold read and one update of ``scheme`` at
    ``vsize``, captured off the store code over SimTransport (the method of
    benchmarks/schemes_des.py): write twice, drop Erda's location hint so
    the read is the cold two-doorbell path, read, update."""
    store = anchor_store(scheme, dev)
    key, value = 11, b"\xa5" * vsize
    store.write(key, value)
    store.write(key, value)
    if scheme == "erda":
        store.client.loc_cache.clear()
    store.transport.take_steps()
    check(store.read(key) == value, f"{scheme} read at {vsize} B returned another value")
    read = store.transport.take_steps()
    store.write(key, value)
    return {"read": read, "write": store.transport.take_steps()}


def paper_anchors(dev, sizes=ANCHOR_SIZES, table1=TABLE1_SIZES) -> dict:
    """The paper's comparison of Erda, Redo Logging and Read After Write:
    mean simulated read latency over ``sizes`` within ``ANCHOR_TOL_US`` of
    62 / 92 / 92 µs; Erda reads use no server CPU and its writes less than
    Redo's; NVM bytes of a create, an update and a delete equal Table 1's
    formulas (Erda's with the repo's record framing); prints the Erda /
    Redo ratio of update bytes, measured and Table 1's (9+N)/(4+2N)."""
    from repro_torch.core.layout import HEADER_SIZE, KEY_BYTES
    from repro_torch.fabric import steps_cpu_s, steps_latency_s
    steps = {s: {v: capture_op_steps(s, v, dev) for v in sizes} for s in ANCHOR_READ_US}
    out = {"read_us": {}, "write_us": {}}
    for scheme, by_size in steps.items():
        out["read_us"][scheme] = {v: steps_latency_s(st["read"]) * 1e6 for v, st in by_size.items()}
        out["write_us"][scheme] = {v: steps_latency_s(st["write"]) * 1e6
                                   for v, st in by_size.items()}
        mean = sum(out["read_us"][scheme].values()) / len(sizes)
        out.setdefault("mean_read_us", {})[scheme] = mean
        check(abs(mean - ANCHOR_READ_US[scheme]) <= ANCHOR_TOL_US,
              f"{scheme} mean simulated read {mean:.2f} us, paper "
              f"{ANCHOR_READ_US[scheme]} +- {ANCHOR_TOL_US}")
    mid = 1024 if 1024 in sizes else sizes[-1]
    cpu_us = {s: {op: steps_cpu_s(steps[s][mid][op]) * 1e6 for op in ("read", "write")}
              for s in steps}
    check(cpu_us["erda"]["read"] == 0.0 and cpu_us["redo"]["read"] > 0.0,
          f"server CPU of a read: {cpu_us}")
    check(0.0 < cpu_us["erda"]["write"] < cpu_us["redo"]["write"],
          f"server CPU of a write: {cpu_us}")
    out["server_cpu_us_at"] = {"value_size": mid, **cpu_us}
    table = {}
    for vsize in table1:
        n = KEY_BYTES + vsize  # Table 1's N: the key-value pair
        paper = {"erda": (KEY_BYTES + 10 + n, 9 + n, KEY_BYTES + 9),
                 "redo": (KEY_BYTES + 12 + 2 * n, 4 + 2 * n, KEY_BYTES + 8),
                 "raw": (KEY_BYTES + 12 + 2 * n, 4 + 2 * n, KEY_BYTES + 8)}
        # Erda's records carry an 11 B header (the paper's 5 B) and its
        # atomic word is one 8 B store (the paper counts 5 programmed bytes):
        # tests/test_nvm_counts.py holds it to these framed formulas
        want = dict(paper, erda=(10 + 8 + HEADER_SIZE + n, 8 + HEADER_SIZE + n,
                                 8 + HEADER_SIZE + KEY_BYTES))
        row = {}
        for scheme in paper:
            s = anchor_store(scheme, dev, sim=False)
            got = []
            for op in (lambda: s.write(1, b"c" * vsize), lambda: s.write(1, b"u" * vsize),
                       lambda: s.delete(1)):
                b0 = s.dev.stats.snapshot()
                op()
                got.append(s.dev.stats.delta(b0).bytes_written)
            check(tuple(got) == want[scheme],
                  f"{scheme} NVM bytes (create, update, delete) at {vsize} B: {got}, "
                  f"want {want[scheme]}")
            row[scheme] = {"measured": got, "table1": list(paper[scheme])}
        row["erda_redo_update_ratio"] = row["erda"]["measured"][1] / row["redo"]["measured"][1]
        row["table1_update_ratio"] = paper["erda"][1] / paper["redo"][1]
        table[vsize] = row
    out["table1_nvm_bytes"] = table
    return out


def ycsb_summary(r: dict, wall_s: float, launches: int, shapes: dict) -> dict:
    """The printed part of a ``run_store_workload`` report."""
    c = r["contended"]
    lat = c["latency"]["all"]
    return {"workload": r["workload"], "batch_size": r["batch_size"],
            "reads": r["reads"], "writes": r["writes"], "threads": c["n_threads"],
            "throughput_kops": c["throughput_kops"], "p50_us": lat["p50_us"],
            "p99_us": lat["p99_us"], "spec_hits": r["spec_hits"],
            "spec_misses": r["spec_misses"], "wall_s": wall_s, "crc_launches": launches,
            "crc_shapes": {str(k): v for k, v in shapes.items()}}


def run_ycsb(dev, *, anchors=(ANCHOR_SIZES, TABLE1_SIZES), ycsb=YCSB, runs=YCSB_RUNS,
             shard=YCSB_SHARD, fault_shard=FAULT_SHARD, chaos_shard=CHAOS_SHARD,
             failover=FAILOVER, chaos=None, elastic=None, profile_ops: int = 2000) -> dict:
    """The paper's comparison on the card (every Erda verify on ``dev``):
    the latency, server-CPU and Table 1 anchors; YCSB A, B and C on a
    4-shard erda-cluster over SimTransport at ``ycsb`` (the workload checks
    every read against its model and raises on a mismatch), replayed by the
    contended threads; then the guarantees under faults on replicated
    clusters — the kill-a-shard run, the quorum chaos run (replication 3)
    and elastic scale-out and scale-in — each of which must report no lost
    acknowledged write and no stale read.  Every simulated µs is the
    paper's calibrated model, not the card's time.  One ycsb_c run of
    ``profile_ops`` unbatched reads is profiled for the CRC kernel's device
    time."""
    from repro_torch.kernels import ops
    from repro_torch.workloads.ycsb import (run_chaos_workload, run_elastic_workload,
                                            run_failover_workload, run_store_workload)
    crc = ops.COUNTS["crc32_batch"]
    ops.reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    out = {"anchors": paper_anchors(dev, *anchors)}
    out["anchors"]["wall_s"] = time.perf_counter() - t0
    out["ycsb"] = []
    for workload, batch in runs:
        store = erda_cluster(dev, shard, n_shards=ycsb["n_shards"])
        t0 = time.perf_counter()
        r, launches, shapes = crc_launched(lambda: run_store_workload(
            store, workload, n_ops=ycsb["n_ops"], n_keys=ycsb["n_keys"],
            value_size=ycsb["value_size"], batch_size=batch,
            contended_threads=ycsb["threads"]))
        check(r["reads"] + r["writes"] == ycsb["n_ops"], f"{workload}: ops lost")
        check(dev.type == "cpu" or launches > 0 or r["reads"] == 0,
              f"{workload} batch {batch}: no CRC launch on the card")
        out["ycsb"].append(ycsb_summary(r, time.perf_counter() - t0, launches, shapes))
    faults = {
        "failover": lambda: run_failover_workload(
            erda_cluster(dev, fault_shard, sim=False, n_shards=4, replication=2),
            **failover),
        "chaos": lambda: run_chaos_workload(
            erda_cluster(dev, chaos_shard, sim=False, n_shards=2, replication=3),
            **(chaos or {})),
        "elastic": lambda: run_elastic_workload(
            erda_cluster(dev, fault_shard, sim=False, n_shards=4, replication=2),
            **(elastic or {}))}
    out["faults"] = {}
    for name, run in faults.items():
        t0 = time.perf_counter()
        r, launches, _shapes = crc_launched(run)
        # the workloads raise on a lost or stale read; the chaos and elastic
        # reports also count them
        lost, stale = r.get("lost_acked_writes", 0), r.get("stale_reads", 0)
        check(lost == 0 and stale == 0, f"{name}: {lost} lost acked writes, {stale} stale reads")
        check(dev.type == "cpu" or launches > 0, f"{name}: no CRC launch on the card")
        out["faults"][name] = {
            k: r[k] for k in ("n_ops", "reads", "writes", "failovers", "denied_ops",
                              "faults", "kills", "partitions", "heals", "shards_path",
                              "max_ratio", "straggler_rejections", "epoch_bumps",
                              "degraded_reads", "stale_rejected") if k in r}
        out["faults"][name].update(lost_acked_writes=lost, stale_reads=stale,
                                   wall_s=time.perf_counter() - t0, crc_launches=launches)
    out["crc32_batch"] = {"launches": crc.launches,
                          "shapes": {str(k): v for k, v in crc.shapes.items()}}
    # beside the main path: one profiled run of unbatched reads
    profiled = erda_cluster(dev, shard, n_shards=ycsb["n_shards"])
    out["profiled"] = dict(uncounted(lambda: crc_profile(lambda: run_store_workload(
        profiled, "ycsb_c", n_ops=profile_ops, n_keys=max(profile_ops // 2, 1),
        value_size=ycsb["value_size"]), dev)), run=f"ycsb_c {profile_ops} ops unbatched")
    return out


def run_serve_at_load(dev, *, at_load=AT_LOAD, kops=AT_LOAD_KOPS, slo=AT_LOAD_SLO,
                      slo_kops=AT_LOAD_SLO_KOPS, page_vsize=PAGE_VSIZE) -> dict:
    """KV page serving at load (examples/serve_kv.py's settings), the page
    traces captured off real ``ErdaCluster`` ops whose every verify runs on
    ``dev``: 120 and 900 KOp/s with per-op and coalesced doorbells; 400
    and 3840 KOp/s with shared-QP coalescing under a 250 µs SLO, queue-bound
    and deadline admission; and ``page_vsize`` pages (one olmo_1b KV head's
    16-token bf16 block) at 120 and 900 KOp/s, coalesced.  Fails unless the
    p99 at 900 KOp/s is above the p99 at 120, past the knee deadline
    admission's goodput is at least the queue's, every shared-QP schedule
    is a legal interleaving of the client streams, and every capture on
    the card launched the CRC kernel.  Latencies are simulated µs."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (capture_page_fetch_traces, check_schedule_legality,
                                     engine)
    crc = ops.COUNTS["crc32_batch"]
    engine._page_traces.clear()  # the phase captures its own traces on dev
    ops.reset_counts()  # the main path starts here
    runs = {}

    def serve(label, offered, **kw):
        captures = len(engine._page_traces)
        t0 = time.perf_counter()
        r, launches, shapes = crc_launched(
            lambda: engine.serve_kv_at_load(offered, device=dev, **kw))
        captured = len(engine._page_traces) > captures
        check(not captured or dev.type == "cpu" or launches > 0,
              f"{label}: the capture launched no CRC kernel")
        lat = r["latency"]["all"]
        row = {"offered_kops": offered, "throughput_kops": r["throughput_kops"],
               "goodput_kops": r["slo"]["goodput_kops"] if "slo" in r else None,
               "p50_us": lat["p50_us"], "p99_us": lat["p99_us"], "dropped": r["dropped"],
               "shed": r["shed"], "mean_batch": r["mean_batch"],
               "nic_utilization": [p["nic_utilization"] for p in r["ports"]],
               "captured": captured, "crc_launches": launches,
               "crc_shapes": {str(k): v for k, v in shapes.items()},
               "wall_s": time.perf_counter() - t0}
        if r.get("schedule_detail"):
            legal = check_schedule_legality(r["schedule_detail"], kw["n_clients"])
            check(legal["violations"] == 0, f"{label}: {legal['violations']} illegal dispatches")
            row["schedule_violations"] = 0
        runs[label] = row
        return r

    for offered in kops:
        for coalesce in (False, True):
            serve(f"{offered:g}_{'coalesced' if coalesce else 'per_op'}", offered,
                  coalesce=coalesce, **at_load)
    lo, hi = (runs[f"{k:g}_coalesced"]["p99_us"] for k in kops)
    check(hi > lo, f"p99 at {kops[1]:g} KOp/s ({hi} us) not above {kops[0]:g}'s ({lo} us)")
    for offered in slo_kops:
        for admission in ("queue", "slo"):
            serve(f"{offered:g}_{admission}", offered, admission=admission,
                  collect_schedule=True, **slo)
    q, s = (runs[f"{slo_kops[1]:g}_{a}"]["goodput_kops"] for a in ("queue", "slo"))
    check(s >= q, f"past the knee slo goodput {s} < queue goodput {q}")
    for offered in kops:
        serve(f"{offered:g}_page{page_vsize}", offered, vsize=page_vsize, **at_load)
    out = {"runs": runs, "crc32_batch": {
        "launches": crc.launches, "shapes": {str(k): v for k, v in crc.shapes.items()}}}
    # beside the main path: one profiled capture of the pages
    out["profiled"] = dict(uncounted(lambda: crc_profile(lambda: capture_page_fetch_traces(
        n_shards=at_load["n_shards"], vsize=page_vsize, device=dev), dev)),
        run=f"capture_page_fetch_traces vsize {page_vsize}")
    return out


def flash_entry(dev, launches: int, shapes: dict, also=()) -> dict:
    """The flash kernel at the main path's most frequent launch (a serve
    prefill's shape and dtype), beside its plain version, SDPA and its
    bound; ``also`` lists other launch keys of the main paths reported the
    same way (gemma3_12b's head_dim 256, zamba2's and whisper's).  A key in
    ``NON_CAUSAL_FLASH`` is timed without the causal mask, as its path
    launches it."""
    main_key = max(shapes, key=shapes.get)
    *shape, dtype = main_key
    case = flash_case(tuple(shape), dtype, main_key not in NON_CAUSAL_FLASH, seed=7, dev=dev)
    more = []
    for key in also:
        *other, odtype = key
        c = flash_case(tuple(other), odtype, key not in NON_CAUSAL_FLASH, seed=8, dev=dev)
        more.append({k: c[k] for k in ("shape", "dtype", "causal", "max_abs_err", "ms",
                                       "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "call_ms")}
                    | {"launches": shapes.get(key, 0)})
    return {"name": "flash_attention", "route": "cuda", "also": more,
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:70",
            "launches": launches, "matches_plain": True,
            "max_abs_err": case["max_abs_err"], "shape": list(shape),
            "dtype": dtype, "causal": case["causal"], "ms": case["ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"], "call_ms": case["call_ms"]}


def verify_round_trip(n: int, w: int, dev, reps: int = 200) -> dict:
    """Host ms of one ``layout.verify_records`` call on ``n`` records whose
    rows are ``w`` words (values of 4w - 20 B): what a read pays for its
    verify on the card — the copy of the rows to it, the launch, the copy
    of the CRCs back and the sync — beside host zlib on the same records.
    Its launches are left out of the counts."""
    from repro_torch.core import layout
    bufs = [layout.pack_record(k + 1, bytes([k % 251]) * (4 * w - 20)) for k in range(n)]
    reps = reps if dev.type == "cuda" else 1

    def verify():
        check(bool(layout.verify_records(bufs, dev).all()), f"verify_records at {(n, w)}")
    uncounted(verify)
    t0 = time.perf_counter()
    for _ in range(reps):
        uncounted(verify)
    verify_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        [zlib.crc32(b) for b in bufs]
    return {"verify_call_ms": verify_ms,
            "zlib_ms": (time.perf_counter() - t0) * 1e3 / reps}


def des_crc_keys(shapes: dict) -> list:
    """The DES phases' CRC batches the kernels line reports: at each of
    ``DES_CRC_WIDTHS``, the most launched batch (a single read's) and the
    one with the most rows (a batched read's or a page capture's)."""
    keys = []
    for w in DES_CRC_WIDTHS:
        at = {k: n for k, n in shapes.items() if k[1] == w}
        if at:
            keys += [k for k in dict.fromkeys((max(at, key=at.get), max(at)))
                     if k not in keys]
    return keys


def crc_entry(dev, launches: int, shapes: dict, also=(), also_shapes=None) -> dict:
    """The CRC kernel at the main path's batch with the most rows (a KV
    restore's per-shard batch), beside its plain version and its bound;
    ``also`` lists other batches of the main paths (the DES phases') reported
    the same way, with their launches in ``also_shapes`` and a verify call's
    host round trip beside zlib.  Batches of rows wider than
    ``PLAIN_CRC_WORDS`` are left out by the caller: the plain version's
    per-byte loop would take minutes on them."""
    n, w = max(shapes, key=lambda s: (s[0], s[1]))
    case = crc_case(n, w, seed=7, dev=dev)
    more = []
    for i, (rows, width) in enumerate(also):
        c = crc_case(rows, width, seed=8 + i, dev=dev)
        more.append({"shape": [rows, width], "launches": (also_shapes or {}).get((rows, width), 0),
                     "max_abs_err": 0, "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
                     **verify_round_trip(rows, width, dev)})
    return {"name": "crc32_batch", "route": "cuda", "also": more,
            "source": "src/repro_torch/kernels/csrc/crc32.cu",
            "replaces": "src/repro/kernels/crc32.py:61",
            "launches": launches, "matches_plain": True, "max_abs_err": 0,
            "shape": [n, w], "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,crc32,flash_attention,kv_pages,"
                    "checkpoint,ycsb,serve_at_load,serve,serve_gemma3,serve_granite_moe,"
                    "serve_gemma3_12b,serve_rwkv6,serve_zamba2,serve_whisper,"
                    "train,dryrun,kernels")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs the port on a CUDA device only", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    # float32 products in full float32 (the model check's tolerance)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    info = phase_device()
    if "crc32" in phases:
        for case in phase_crc32(dev):
            emit("crc32", **case)
    if "flash_attention" in phases:
        for case in run_flash_attention(dev):
            emit("flash_attention", **case)
    if "trace_check" in phases:  # not a default phase
        emit("trace_check", **uncounted(lambda: run_trace_check(dev)))
    # each main-path phase resets the counts where its path starts; these sum
    # what every kernel launched on the main paths, and at which shapes
    launches = {name: 0 for name in ops.COUNTS}
    shapes = {name: {} for name in ops.COUNTS}
    des_shapes = {}  # the CRC batches of the DES phases' main paths
    results = {}
    runs = [("kv_pages", run_kv_pages), ("checkpoint", run_checkpoint),
            ("ycsb", run_ycsb), ("serve_at_load", run_serve_at_load),
            ("serve", run_serve), ("serve_gemma3", run_serve_gemma3),
            ("serve_granite_moe", run_serve_granite_moe),
            ("serve_gemma3_12b", run_serve_gemma3_12b), ("serve_rwkv6", run_serve_rwkv6),
            ("serve_zamba2", run_serve_zamba2), ("serve_whisper", run_serve_whisper),
            ("train", run_train)]
    # the card against the CPU on small f32 configs, before the phase
    model_check = lambda label: ("model_check", label, run_model_check, MODEL_CHECKS[label])
    train_check = lambda label: ("train_check", label, run_train_check, TRAIN_CHECKS[label])
    checks = {"ycsb": [("des_check", "card_vs_cpu", run_des_check, {})],
              "serve": [model_check("olmo_1b")],
              "serve_gemma3": [model_check("local_global"), model_check("pixtral")],
              "serve_granite_moe": [model_check("granite_moe"), model_check("mixtral")],
              "serve_gemma3_12b": [model_check("gemma3_12b")],
              "serve_rwkv6": [model_check("rwkv6")],
              "serve_zamba2": [model_check("zamba2")],
              "serve_whisper": [model_check("whisper")],
              "train": [train_check(label) for label in TRAIN_CHECKS]}
    for name, run in runs:
        if name not in phases:
            continue
        gc.collect()  # what earlier phases left on the card goes back
        torch.cuda.empty_cache()
        for check_name, label, check_fn, kwargs in checks.get(name, []):
            emit(check_name, label=label, **check_fn(dev, **kwargs))
        t0 = time.perf_counter()
        res = run(dev)
        emit(name, card=info["nvidia_smi"], phase_s=time.perf_counter() - t0, **res)
        results[name] = res
        for kname, count in ops.COUNTS.items():
            launches[kname] += count.launches
            for k, v in count.shapes.items():
                shapes[kname][k] = shapes[kname].get(k, 0) + v
        if name in ("ycsb", "serve_at_load"):
            for k, v in ops.COUNTS["crc32_batch"].shapes.items():
                des_shapes[k] = des_shapes.get(k, 0) + v
    if "dryrun" in phases:
        t0 = time.perf_counter()
        res = run_dryrun(dev, train=results.get("train"))
        emit("dryrun", card=info["nvidia_smi"], phase_s=time.perf_counter() - t0, **res)
    emit("traces", **TRACES)
    if "kernels" in phases:
        entries = []
        crc_shapes = {k: v for k, v in shapes["crc32_batch"].items()
                      if k[1] <= PLAIN_CRC_WORDS}
        if crc_shapes:
            entries.append(crc_entry(dev, launches["crc32_batch"], crc_shapes,
                                     also=des_crc_keys(des_shapes), also_shapes=des_shapes))
        if shapes["flash_attention"]:
            fs = shapes["flash_attention"]
            also = [k for table in (GEMMA3_12B_PREFILL_FLASH, ZAMBA2_PREFILL_FLASH,
                                    WHISPER_PREFILL_FLASH)
                    for k in table if k in fs and k != max(fs, key=fs.get)]
            entries.append(flash_entry(dev, launches["flash_attention"], fs, also=also))
        print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
