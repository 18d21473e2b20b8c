"""Serving examples on the PyTorch/CUDA port (every page fetch CRC-verified
on ``--device``: on the card, through the CRC kernel).

1. Batched greedy decode with Erda-backed KV snapshots and a simulated
   mid-decode preemption — the continuation is bit-identical.
2. The same page store served AT LOAD: open-loop Poisson arrivals fetch
   KV pages through the contention-aware DES at two offered loads — one
   below the saturation knee (tail ~= the uncontended latency) and one past
   it (queueing tail, adaptive doorbell coalescing earning its keep).
3. Shared-QP coalescing + SLO-aware admission: 16 streams merge doorbell
   runs on shared per-(host,shard) QPs, and every request carries a
   deadline (``--slo-us``, default 250).  Below the knee both admission
   policies serve everything in-deadline; at 1.2× past it the queue-bound
   policy's completions are almost all late while deadline shedding keeps
   goodput near saturation.

Latencies of parts 2 and 3 are simulated µs (the paper's calibrated model),
whatever device verified the pages.

    PYTHONPATH=src python examples/serve_kv_torch.py [--slo-us 250] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.launch.serve import serve
from repro_torch.serving import serve_kv_at_load

#: offered loads (KOp/s) below the knee and past saturation, of parts 2 and 3
KNEE_KOPS = (120.0, 900.0)
SLO_KOPS = (400.0, 3840.0)


def knee_runs(device, horizon_s: float = 0.02) -> list:
    """(offered KOp/s, coalesce, report) of part 2: 8 clients, 2 shards."""
    return [(offered, coalesce,
             serve_kv_at_load(offered, n_clients=8, n_shards=2, horizon_s=horizon_s,
                              read_frac=0.9, coalesce=coalesce, device=device))
            for offered in KNEE_KOPS for coalesce in (False, True)]


def slo_runs(device, slo_us: float = 250.0, horizon_s: float = 0.006) -> list:
    """(offered KOp/s, admission, report) of part 3: 16 clients on 4 shards,
    shared QPs, a deadline of ``slo_us``."""
    return [(offered, admission,
             serve_kv_at_load(offered, n_clients=16, n_shards=4, horizon_s=horizon_s,
                              read_frac=0.9, seed=3, share_qp=True, b_max=64,
                              capture_batches=(1, 2, 4, 8, 16, 32, 64),
                              slo_us=slo_us, admission=admission, device=device))
            for offered in SLO_KOPS for admission in ("queue", "slo")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slo-us", type=float, default=250.0,
                    help="per-request deadline for the SLO-admission demo (µs)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # -------------------------------------------- preemption / recovery (model)
    clean = serve(arch="rwkv6_1p6b", scale="smoke", batch=2, prompt_len=32,
                  tokens=16, snapshot_every=4, device=args.device)
    crashy = serve(arch="rwkv6_1p6b", scale="smoke", batch=2, prompt_len=32,
                   tokens=16, snapshot_every=4, crash_at=9, device=args.device)
    np.testing.assert_array_equal(clean, crashy)
    print(f"generated {clean.shape[1]} tokens × {clean.shape[0]} requests")
    print("preempted replica restored from the Erda page store: outputs identical")

    # ---------------------------------------------- serving at load (DES side)
    print("\nopen-loop KV page fetches, 2-shard Erda cluster, 8 clients:")
    print(f"{'offered':>10} {'coalesce':>9} {'achieved':>10} {'p50':>9} "
          f"{'p99':>9} {'drops':>6} {'batch':>6}")
    runs = knee_runs(args.device)
    for offered_kops, coalesce, r in runs:
        lat = r["latency"]["all"]
        print(f"{offered_kops:8.0f}k {str(coalesce):>9} "
              f"{r['throughput_kops']:8.1f}k {lat['p50_us']:7.1f}us "
              f"{lat['p99_us']:7.1f}us {r['dropped']:6d} "
              f"{r['mean_batch']:6.2f}")
    # the coalesced runs are serve_kv_at_load's defaults at each load
    lo, hi = (r for _k, coalesce, r in runs if coalesce)
    assert hi["latency"]["all"]["p99_us"] > lo["latency"]["all"]["p99_us"]
    print("past the knee the p99 queueing tail opens up; coalescing holds "
          "throughput at the offered load the per-op doorbells cannot reach")

    # ----------------------------- shared-QP coalescing + SLO admission (DES)
    print(f"\nshared-QP coalescing, 16 clients / 4 shards, slo={args.slo_us:.0f}us:")
    print(f"{'offered':>10} {'admission':>9} {'achieved':>10} {'goodput':>10} "
          f"{'shed':>6} {'late':>6} {'p99':>9}")
    for offered_kops, admission, r in slo_runs(args.device, args.slo_us):
        s = r["slo"]
        print(f"{offered_kops:8.0f}k {admission:>9} "
              f"{r['throughput_kops']:8.1f}k {s['goodput_kops']:8.1f}k "
              f"{s['shed']:6d} {s['late']:6d} "
              f"{r['latency']['all']['p99_us']:7.1f}us")
    print("past the knee the queue-bound backlog makes completions late "
          "(throughput without goodput); deadline shedding serves only feasible "
          "requests and keeps goodput near saturation")


if __name__ == "__main__":
    main()
