"""``chip_smoke.py``'s phases rehearsed on the CPU at a tiny size (plain
versions of the kernels), and its refusal to run without a CUDA device or
outside the repository."""
import dataclasses
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


def test_flash_attention_phase_on_cpu():
    out = chip_smoke.run_flash_attention(
        torch.device("cpu"), shapes=[((2, 40, 32), "float32", True),
                                     ((2, 33, 64), "bfloat16", False)])
    assert [c["max_abs_err"] for c in out] == [0.0, 0.0]  # plain vs plain
    assert all(c["ms"] is None for c in out)  # no device times off the card


def test_flash_bound_at_the_serve_shape_is_bytes():
    ms, by = chip_smoke.flash_bound_ms(64, 256, 128, "bfloat16", True)
    assert by == "bytes"
    assert ms == pytest.approx(4 * 64 * 256 * 128 * 2 / 3.35e12 * 1e3)
    ms, by = chip_smoke.flash_bound_ms(32, 2048, 128, "bfloat16", True)
    assert by == "operations"
    assert ms == pytest.approx(2 * 32 * 2048**2 * 128 / 989e12 * 1e3)


def test_model_check_on_cpu():
    out = chip_smoke.run_model_check(torch.device("cpu"), batch=1,
                                     prompt_len=8, steps=2)
    assert out["max_abs_err"] == 0.0


def test_serve_phase_on_cpu():
    from repro_torch.configs import get_config
    out = chip_smoke.run_serve(torch.device("cpu"),
                               cfg=get_config("olmo_1b").scaled_down(),
                               batch=2, prompt_len=16, tokens=6,
                               snapshot_every=2, crash_at=3)
    assert out["tokens_equal"]
    assert out["preempted"]["restore_ms"] is not None
    assert out["clean"]["snapshots"] == out["preempted"]["snapshots"] == 3
    assert out["flash_attention"]["launches"] == 0  # the CPU runs the plain version
    assert out["flash_attention"]["by_route"] == {"wgmma": 0, "cuda_core": 0}
    # {pos, k, kv_pos, v}: the k / v leaves are (L, B, S + 128, KV, hd) bf16
    assert out["largest_cache_leaf_bytes"] == 4 * 2 * (16 + 128) * 4 * 32 * 2


def test_crc32_phase_on_cpu():
    """Exact checks (chunk-boundary widths scaled down), then the long-row
    and the two serve-restore cases against zlib only; no device times off
    the card."""
    out = chip_smoke.phase_crc32(torch.device("cpu"),
                                 shapes=[(1, 1), (3, 7), (2, 8)],
                                 long=(2, 300), serve=((3, 1001), (2, 1003)))
    assert [c["shape"] for c in out] == [[1, 1], [3, 7], [2, 8], [2, 300], [3, 1001],
                                         [2, 1003]]
    assert all(c["exact"] and c["ms"] is None for c in out)
    assert out[-1]["plain_ms"] is None and out[-1]["bound_by"] == "bytes"


def test_kernels_line_entries_on_cpu():
    cpu = torch.device("cpu")
    crc = chip_smoke.crc_entry(cpu, 5, {(4, 9): 3, (6, 2): 2})
    assert crc["shape"] == [6, 2] and crc["launches"] == 5 and crc["max_abs_err"] == 0
    flash = chip_smoke.flash_entry(cpu, 3, {(2, 40, 32, "float32"): 2,
                                            (1, 8, 32, "bfloat16"): 1})
    assert flash["shape"] == [2, 40, 32] and flash["dtype"] == "float32"
    assert flash["max_abs_err"] == 0.0 and flash["ms"] is None
    for entry in (crc, flash):
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(entry)
        assert (ROOT / entry["source"]).exists()


def test_flash_shapes_hold_the_tile_edges():
    edges = {s for (bh, s, hd), dtype, _c in chip_smoke.FLASH_SHAPES
             if dtype == "bfloat16" and hd == 128}
    assert {64, 65, 100} <= edges


def tiny_olmo():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("olmo_1b").scaled_down(), n_layers=2,
                               d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                               remat="full")


def test_train_phase_on_cpu():
    out = chip_smoke.run_train(torch.device("cpu"), cfg=tiny_olmo(), batch=2,
                               seq=32, steps=5, ckpt_at=3)
    assert len(out["losses"]) == 5 and len(out["resumed_losses"]) == 2
    assert out["resumed_bitwise_equal"]  # the CPU repeats its arithmetic
    assert out["flash_launches"] == 0 and out["restore_crc_launches"] == 0
    assert out["ckpt_servers"] == 1 and out["save_shards"] > 0
    assert out["max_memory_allocated"] is None  # no device numbers off the card
    assert out["profiled_step"]["busy_share"] is None
    n = out["params"]
    assert out["opt_bytes"] == 22 * n
    assert out["flop_bound_ms"] == pytest.approx(6 * n * 64 / 989e12 * 1e3)


def test_full_config_train_bounds():
    """The train phase's bounds at olmo_1b's full config: 6·N·T a step against
    989 TFLOP/s and 22 bytes a parameter against 3.35 TB/s."""
    from repro_torch.configs import get_config
    n = get_config("olmo_1b").param_count()
    assert n == 1_176_764_416
    assert 6 * n * 8192 / chip_smoke.BF16_TENSOR_OPS_PER_S * 1e3 == pytest.approx(58.48, abs=0.01)
    assert 22 * n / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(7.73, abs=0.01)


def test_train_check_on_cpu():
    out = chip_smoke.run_train_check(torch.device("cpu"), seqs=(16,))
    assert out["max_abs_err"] == 0.0


def tiny_local_global():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gemma3_27b").scaled_down(), n_layers=8)


def test_serve_gemma3_phase_on_cpu():
    """The serve_gemma3 phase on gemma3's scaled-down config with its tail,
    a prompt past the 64-token window: ring caches through a preemption."""
    out = chip_smoke.run_serve_gemma3(torch.device("cpu"), cfg=tiny_local_global(),
                                      prompt_len=80, tokens=6, snapshot_every=2,
                                      crash_at=3)
    assert out["tokens_equal"] and out["prefills"] == 2
    assert out["attn_pattern"] == "local_global" and out["window"] == 64
    # ['local']['k'] is (1, 5, 1, 64, 2, 32) bf16
    assert out["largest_cache_leaf"] == "['local']['k']"
    assert out["largest_cache_leaf_bytes"] == 5 * 64 * 2 * 32 * 2
    assert out["page_store"]["n_shards"] >= 2
    assert out["page_store"]["segment_size"] > out["largest_cache_leaf_bytes"]
    assert out["flash_attention"]["launches"] == 0  # the CPU runs the plain version
    assert out["max_memory_allocated"] is None


def test_gemma3_27b_prefill_flash_shape_and_bound():
    """Each serve_gemma3 prefill runs the flash kernel on its 10 global
    layers at (1 x 32 heads, 1536, 128); the bound of one call is its
    4·BH·S²·hd/2 operations at 989 TFLOP/s."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_plan
    cfg = get_config("gemma3_27b")
    assert cfg.param_count() == 27_007_647_744
    assert layer_plan(cfg).count("full") == 10
    assert chip_smoke.GEMMA3_PREFILL_FLASH == {(32, 1536, 128, "bfloat16"): 10}
    assert ((32, 1536, 128), "bfloat16", True) in chip_smoke.FLASH_SHAPES
    ms, by = chip_smoke.flash_bound_ms(32, 1536, 128, "bfloat16", True)
    assert by == "operations"
    assert ms == pytest.approx(4 * 32 * 1536**2 * 128 / 2 / 989e12 * 1e3)
    assert ms == pytest.approx(0.0195, abs=1e-4)


@pytest.mark.parametrize("label", ["local_global", "pixtral"])
def test_model_check_on_cpu_for_the_new_patterns(label):
    kwargs = dict(chip_smoke.MODEL_CHECKS[label], prompt_len=72 if label == "local_global" else 8)
    out = chip_smoke.run_model_check(torch.device("cpu"), batch=1, steps=2, **kwargs)
    assert out["max_abs_err"] == 0.0


@pytest.mark.parametrize("label", ["local_global", "pixtral"])
def test_train_check_on_cpu_for_the_new_patterns(label):
    kwargs = dict(chip_smoke.TRAIN_CHECKS[label], seqs=(72,) if label == "local_global" else (8,))
    out = chip_smoke.run_train_check(torch.device("cpu"), **kwargs)
    assert out["max_abs_err"] == 0.0
