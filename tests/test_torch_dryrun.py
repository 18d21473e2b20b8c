"""The port's dry-run (``repro_torch.launch.dryrun``): every family's train,
prefill and decode step on a fake (2, 2, 2) pod × data × model mesh, built
as ``tests/test_dryrun_small.py`` builds its configs; on a (1, 1) mesh the
count equals ``FlopCounterMode`` of the plain step exactly, with no
collective; a train step whose 3 heads the mesh's 'model' axis does not
divide; and the CLI's record for olmo_1b × train_4k on the 16 × 16
production mesh.  Each fake world lives in a subprocess of its own (the
cases run side by side), so no process group outlives this file."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MINI = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.roofline.analysis import collective_bytes
    fake_world(8)
    mesh = make_test_mesh(data=2, model=2, pod=2)
    for arch in sys.argv[1:]:
        cfg = dataclasses.replace(get_config(arch).scaled_down(), d_model=64,
                                  head_dim=16, n_heads=4,
                                  n_kv_heads=2 if arch != "whisper_small" else 4)
        for kind in ("train", "prefill", "decode"):
            got = count_cell(cfg, ShapeConfig(kind, 64, 8, kind), mesh)
            c = got["counter"]
            coll = collective_bytes(c.records)
            coll.pop("_counts")
            print(json.dumps({"arch": arch, "kind": kind, "flops": c.flops,
                              "bytes": c.bytes, "collective": sum(coll.values()),
                              "argument": got["argument"], "temp": c.peak}), flush=True)
""")

#: the (1, 1) mesh's count against FlopCounterMode of the plain step on the
#: same meta inputs
ONE = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.train.step import make_train_state_abstract
    fake_world(1)
    mesh = make_test_mesh(data=1, model=1)
    for arch in sys.argv[1:]:
        cfg = get_config(arch).scaled_down()
        model = get_model(cfg, "cpu")
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig(kind, 32, 2, kind)
            got = count_cell(cfg, shape, mesh)
            inputs = model.input_specs(shape)
            with FlopCounterMode(display=False) as fc:
                if kind == "train":
                    make_train_step(model, AdamWConfig())(
                        make_train_state_abstract(model, max_seq=32), inputs)
                elif kind == "prefill":
                    model.prefill(model.init_abstract(max_seq=32), inputs)
                else:
                    model.decode_step(model.init_abstract(max_seq=32), inputs["cache"],
                                      inputs["token"])
            print(json.dumps({"arch": arch, "kind": kind, "flops": got["counter"].flops,
                              "plain": fc.get_total_flops(),
                              "records": got["counter"].records}), flush=True)
""")

#: a train step whose head count the mini mesh's 'model' axis (2) does not
#: divide: 3 heads (1 KV head; whisper 3), whose merge before the
#: row-parallel ``wo`` gets back a gradient sharded over 'model'
UNEVEN = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import fake_world, make_test_mesh
    fake_world(8)
    mesh = make_test_mesh(data=2, model=2, pod=2)
    for arch in sys.argv[1:]:
        cfg = dataclasses.replace(get_config(arch).scaled_down(), d_model=48, head_dim=16,
                                  n_heads=3, n_kv_heads=3 if arch == "whisper_small" else 1)
        c = count_cell(cfg, ShapeConfig("train", 64, 8, "train"), mesh)["counter"]
        print(json.dumps({"arch": arch, "flops": c.flops, "bytes": c.bytes}), flush=True)
""")
UNEVEN_ARCHS = ("olmo_1b", "whisper_small")

#: families grouped so that each process shares DTensor's sharding caches
MINI_GROUPS = [("olmo_1b", "gemma3_12b", "mistral_nemo_12b"),
               ("gemma3_27b", "pixtral_12b"), ("mixtral_8x22b", "granite_moe_3b"),
               ("rwkv6_1p6b",), ("zamba2_1p2b",), ("whisper_small",)]
ONE_ARCHS = ("olmo_1b", "granite_moe_3b", "whisper_small")


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's subprocess, started together; {name: (returncode, out)}."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    cmds = {f"mini:{','.join(g)}": [sys.executable, "-c", MINI, *g] for g in MINI_GROUPS}
    cmds["one"] = [sys.executable, "-c", ONE, *ONE_ARCHS]
    cmds["uneven"] = [sys.executable, "-c", UNEVEN, *UNEVEN_ARCHS]
    cmds["cli"] = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo_1b",
                   "--shape", "train_4k", "--mesh", "single", "--out", str(out_dir)]
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}
    done = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        done[name] = (p.returncode, out, err)
    done["cli_out"] = out_dir
    return done


def lines(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, out + err[-4000:]
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("group", MINI_GROUPS, ids=lambda g: ",".join(g))
def test_every_family_step_runs_on_the_mini_mesh(runs, group):
    got = lines(runs, f"mini:{','.join(group)}")
    assert [(r["arch"], r["kind"]) for r in got] == \
        [(a, k) for a in group for k in ("train", "prefill", "decode")]
    for r in got:
        assert r["flops"] > 0 and r["bytes"] > 0 and r["argument"] > 0, r
        assert r["collective"] > 0, r  # the mesh moved activations or weights


def test_train_step_with_heads_the_model_axis_does_not_divide(runs):
    """The backward of the heads' merge before ``wo`` gets a gradient
    sharded over 'model', which the merge's backward must split into 3
    heads: ``rules.splittable_grad`` gathers it first (without it, olmo_1b's
    step fails in DTensor's view, as granite_moe_3b x train_4k did)."""
    got = lines(runs, "uneven")
    assert [r["arch"] for r in got] == list(UNEVEN_ARCHS)
    assert all(r["flops"] > 0 and r["bytes"] > 0 for r in got), got


def test_one_device_count_equals_flop_counter_mode(runs):
    got = lines(runs, "one")
    assert [(r["arch"], r["kind"]) for r in got] == \
        [(a, k) for a in ONE_ARCHS for k in ("train", "prefill", "decode")]
    for r in got:
        assert r["flops"] == r["plain"] > 0, r
        assert r["records"] == [], r


def test_cli_record_for_olmo_train_4k_on_the_production_mesh(runs):
    rc, out, err = runs["cli"]
    assert rc == 0, out + err[-4000:]
    rec = json.loads((runs["cli_out"] / "olmo_1b__train_4k__single.json").read_text())
    assert rec["ok"] is True and rec["chips"] == 256 and rec["mesh"] == "single"
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["peaks"]["flops"] == 989e12 and rec["peaks"]["hbm_bw"] == 3.35e12
    assert rec["hlo_flops_total"] == rec["flops_per_device"] * 256
    assert rec["compute_s"] == pytest.approx(rec["flops_per_device"] / 989e12)
    assert rec["memory_s"] == pytest.approx(rec["bytes_per_device_accessed"] / 3.35e12)
    assert rec["collective_s"] == pytest.approx(rec["collective_bytes_per_chip"] / 50e9)
    assert rec["collective_bytes_per_chip"] > 0
    # the whole 11.8 GB train state, sharded 256 ways, is each device's argument
    assert rec["bytes_per_device"]["argument"] == pytest.approx(11.8e9 / 256, rel=0.02)
    assert rec["model_flops"] == 6.0 * 1_176_764_416 * 4096 * 256

