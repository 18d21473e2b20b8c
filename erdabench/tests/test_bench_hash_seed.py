"""Every run takes one string-hash salt: ``run.pin_hash_seed`` starts the
process again under ``run.HASH_SEED`` whatever salt it was started with,
keeps its arguments and process, and carries the clock of the first start
so that set-up still counts from it."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from erdabench import run

ROOT = Path(__file__).resolve().parents[2]

PROBE = '''
import os, sys, time
from erdabench import run
if not os.path.exists("first_pid"):
    open("first_pid", "w").write(str(os.getpid()))
run.pin_hash_seed("hash_probe")
print(os.environ["PYTHONHASHSEED"], hash("page"), os.getpid() == int(open("first_pid").read()),
      time.perf_counter() - run.T_PROCESS, "ERDABENCH_T_PROCESS" in os.environ,
      " ".join(sys.argv[1:]))
'''


@pytest.mark.parametrize("salt", [None, "1", "12345", run.HASH_SEED])
def test_every_salt_runs_under_the_pinned_one(tmp_path, salt):
    (tmp_path / "hash_probe.py").write_text(PROBE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(tmp_path)])
    if salt is not None:
        env["PYTHONHASHSEED"] = salt
    pinned = subprocess.run([sys.executable, "-c", 'print(hash("page"))'],
                            env=dict(env, PYTHONHASHSEED=run.HASH_SEED),
                            capture_output=True, text=True, check=True).stdout.split()
    out = subprocess.run([sys.executable, "-m", "hash_probe", "--seed", "7"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, check=True).stdout.split()
    seed, hashed, same_process, age, leaked = out[:5]
    assert seed == run.HASH_SEED and [hashed] == pinned
    assert same_process == "True"
    assert 0.0 <= float(age) < 60.0
    assert leaked == "False"
    assert out[5:] == ["--seed", "7"]
