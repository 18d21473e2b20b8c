"""The port's examples (``examples/*_torch.py``) on the CPU, against the JAX
package's: quickstart and elastic_scale print what the JAX examples print,
line for line (both JAX examples are jax-free); serve_kv's at-load runs equal
the JAX package's ``serve_kv_at_load`` at the same arguments (short
horizons); the failure-recovery demo passes its four scenarios; train_lm
trains a few steps with finite losses (its descent assert runs on the
card, in ``chip_smoke.py``'s examples phase)."""
import importlib.util
import math
import runpy
from pathlib import Path

import pytest

from torch_des_parity import canon, mod

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORTED = ("quickstart", "elastic_scale", "serve_kv", "failure_recovery_demo", "train_lm")


def example(name: str):
    """``examples/<name>_torch.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  EXAMPLES / f"{name}_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_example_has_a_port():
    assert sorted(p.stem for p in EXAMPLES.glob("*_torch.py")) == \
        sorted(f"{name}_torch" for name in PORTED)
    assert sorted(p.stem for p in EXAMPLES.glob("*.py") if not p.stem.endswith("_torch")) == \
        sorted(PORTED)


@pytest.mark.parametrize("name", ["quickstart", "elastic_scale"])
def test_example_prints_what_the_jax_example_prints(name, capsys):
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    want = capsys.readouterr().out
    example(name).main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) >= 4


def test_serve_kv_at_load_runs_equal_the_reference():
    """Parts 2 and 3 of serve_kv at 2 ms horizons: every report equal to
    the JAX package's ``serve_kv_at_load`` at the same arguments."""
    ex = example("serve_kv")
    knee = ex.knee_runs("cpu", horizon_s=0.002)
    slo = ex.slo_runs("cpu", slo_us=250.0, horizon_s=0.002)
    ref = mod("repro", "serving").serve_kv_at_load
    want_knee = [ref(k, n_clients=8, n_shards=2, horizon_s=0.002, read_frac=0.9,
                     coalesce=c) for k in ex.KNEE_KOPS for c in (False, True)]
    want_slo = [ref(k, n_clients=16, n_shards=4, horizon_s=0.002, read_frac=0.9, seed=3,
                    share_qp=True, b_max=64, capture_batches=(1, 2, 4, 8, 16, 32, 64),
                    slo_us=250.0, admission=a) for k in ex.SLO_KOPS for a in ("queue", "slo")]
    assert [(k, c) for k, c, _r in knee] == [(k, c) for k in (120.0, 900.0)
                                             for c in (False, True)]
    assert [(k, a) for k, a, _r in slo] == [(k, a) for k in (400.0, 3840.0)
                                            for a in ("queue", "slo")]
    assert [canon(r) for _k, _c, r in knee] == [canon(r) for r in want_knee]
    assert [canon(r) for _k, _a, r in slo] == [canon(r) for r in want_slo]
    assert all(r["completed"] > 0 for _k, _c, r in knee + slo)


def test_failure_recovery_demo_passes_its_four_scenarios(monkeypatch, capsys):
    """The demo's scenarios and asserts, on a 64 MiB checkpoint store with
    16 KiB shards: the default manager's 1 GiB store takes the §4.2
    recovery scan ~80 s on the CPU, and 4 MiB shards the plain CRC ~10 s a
    restore."""
    ex = example("failure_recovery_demo")
    from repro_torch.checkpoint import ErdaCheckpointManager
    from repro_torch.core import ErdaStore, ServerConfig

    def small(device):
        cfg = ServerConfig(device_size=64 << 20, table_capacity=1 << 12, n_heads=2,
                           region_size=8 << 20, segment_size=256 << 10)
        return ErdaCheckpointManager(ErdaStore(cfg, device=device), device=device,
                                     shard_bytes=16 << 10)
    monkeypatch.setattr(ex, "ErdaCheckpointManager", small)
    ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("restore still serves committed step 8 (expected 8)",
                 "CRC fallback serves step 8 (expected 8)",
                 "[train] resumed from Erda checkpoint @ step 8",
                 "resumed and ran 2 more steps — all invariants held"):
        assert line in out.splitlines(), out
    assert "writer died: injected checkpoint-writer crash" in out
    assert "manifest write torn at the NIC cache" in out


def test_train_lm_trains_a_few_steps_on_cpu():
    losses = example("train_lm").train_losses(steps=3, batch=2, seq=32, device="cpu")
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("name", PORTED)
def test_examples_default_to_the_card(name):
    """Without ``--device`` an example asks for CUDA, and raises without it
    instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main([])
