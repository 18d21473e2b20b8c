"""``chip_smoke.py``'s phases rehearsed on the CPU at a tiny size (plain
versions of the kernels), and its refusal to run without a CUDA device or
outside the repository."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from repro_torch.core import ServerConfig

ROOT = Path(__file__).resolve().parents[1]


def test_kv_pages_phase_on_cpu():
    out = chip_smoke.run_kv_pages(
        torch.device("cpu"), n_seqs=2, tokens=64, layers=2, page_tokens=16,
        kv_heads=2, head_dim=8, n_shards=4,
        cfg=ServerConfig(device_size=4 << 20, table_capacity=1 << 10,
                         n_heads=2, region_size=256 << 10,
                         segment_size=64 << 10))
    assert out["pages_per_seq"] == 16
    assert out["torn_fallbacks"] > 0
    assert out["launches"] == 0  # the CPU runs the plain version


def test_checkpoint_phase_on_cpu():
    out = chip_smoke.run_checkpoint(torch.device("cpu"), d=64, d_ff=128,
                                    vocab=100, shard_bytes=4096,
                                    device_size=8 << 20)
    assert out["shards"] > 20
    assert out["recover"]["removed"] == 0


def test_crc_bound_is_the_larger_of_bytes_and_operations():
    ms, by = chip_smoke.crc_bound_ms(2048, 16400)
    assert by == "bytes"
    assert ms == pytest.approx((2048 * 16400 * 4 + 2048 * 4) / 3.35e12 * 1e3)


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert chip_smoke.main([]) == 2


def test_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
