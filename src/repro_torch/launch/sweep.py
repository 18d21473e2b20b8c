"""Dry-run sweep: every applicable (arch × shape × mesh) cell as a
subprocess (each needs a fresh fake process group of 256 or 512 ranks), a
few in parallel — the port of ``repro/launch/sweep.py``.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out artifacts/dryrun --jobs 6
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from repro_torch.configs import SHAPES, ARCH_IDS, cell_applicable


def run_one(arch, shape, mesh, out, timeout=3600):
    # roofline fit (3 compiles) only on the single-pod mesh — the multi-pod
    # pass proves the 'pod' axis shards with one plain lower+compile
    fit = mesh == "single"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out] + (["--fit"] if fit else [])
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    ok = r.returncode == 0
    tag = f"{arch}__{shape}__{mesh}"
    if not ok:
        (pathlib.Path(out) / f"{tag}.FAILED.log").write_text(r.stdout + r.stderr)
    print(f"{'OK ' if ok else 'FAIL'} {tag}  ({time.time()-t0:.0f}s)", flush=True)
    return tag, ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    outp = pathlib.Path(args.out)
    outp.mkdir(parents=True, exist_ok=True)
    cells = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if not cell_applicable(arch, shape):
                continue
            for mesh in meshes:
                if args.skip_done and (outp / f"{arch}__{shape}__{mesh}.json").exists():
                    continue
                cells.append((arch, shape, mesh))
    print(f"sweep: {len(cells)} compiles, {args.jobs} parallel", flush=True)
    results = []
    with ThreadPoolExecutor(args.jobs) as ex:
        futs = [ex.submit(run_one, a, s, m, args.out) for a, s, m in cells]
        for f in futs:
            results.append(f.result())
    n_ok = sum(1 for _, ok in results if ok)
    print(f"sweep done: {n_ok}/{len(results)} ok")
    (outp / "SWEEP_SUMMARY.json").write_text(json.dumps(
        {tag: ok for tag, ok in results}, indent=1))


if __name__ == "__main__":
    main()
