"""``chip_smoke.py``'s phases rehearsed on the CPU at a tiny size (plain
versions of the kernels), and its refusal to run without a CUDA device or
outside the repository."""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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


def test_decode_attention_phase_on_cpu():
    out = chip_smoke.run_decode_attention(
        torch.device("cpu"), shapes=[((2, 40, 4, 1, 32), "float32", None),
                                     ((1, 33, 2, 3, 64), "bfloat16", 0.0078125)])
    # plain vs plain in float32: equal in float32, the output's rounding in
    # bf16, within 2^-8 of each value (its share of the tolerance under 1)
    assert out[0]["max_abs_err"] == 0.0 and out[0]["of_tol"] == 0.0
    assert 0.0 < out[1]["max_abs_err"] and 0.0 < out[1]["of_tol"] <= 1.0
    assert out[1]["tol"] == [2 ** -8, 1e-5]
    assert all(c["ms"] is None for c in out)  # no device times off the card


def test_moe_kernels_phase_on_cpu():
    """Off the card the phase routes and runs the plain versions only: the
    pairs and drops it counts, the bounds from them, no device times."""
    out = chip_smoke.run_moe_kernels(torch.device("cpu"),
                                     shapes=[(2, 512, 32, 8, 2), (2, 1, 32, 8, 2)])
    prefill, decode = out
    assert (prefill["groups"], prefill["g"], prefill["C"]) == (4, 256, 80)
    assert prefill["pairs"] == 2 * 512 * 2 and 0 < prefill["kept"] <= prefill["pairs"]
    assert (decode["groups"], decode["g"], decode["C"], decode["kept"]) == (2, 1, 1, 4)
    assert all(c["ms"] is None and c["plain_ms"] is None for c in out)
    bound = chip_smoke.moe_bound_ms(2, 1, 2, 8, 1, 64, 4, 2)
    assert bound["moe_dispatch"] == pytest.approx((16 * 68 + 2 * 64) / 3.35e12 * 1e3)
    assert chip_smoke.MOE_SHAPES[0] == (4, 3840, 1536, 40, 8)


def test_moe_entries_on_cpu():
    """The kernels line's MoE entries: one a kernel at the widest dispatch
    of the main paths (a prefill's, not a decode step's), with their
    launches by shape; off the card no device times."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import moe as M
    C = M.capacity(get_config("granite_moe_3b"), 16)
    shapes = {"moe_positions": {(4, 16, 8, 40, C): 2, (4, 1, 8, 40, 1): 6},
              "moe_dispatch": {(4, 16, 8, 40, C, 64, "bfloat16"): 2,
                               (4, 1, 8, 40, 1, 64, "bfloat16"): 6}}
    shapes["moe_combine"] = dict(shapes["moe_dispatch"])
    out = chip_smoke.moe_entries(torch.device("cpu"), dict.fromkeys(shapes, 8), shapes)
    assert [e["name"] for e in out] == list(chip_smoke.MOE_KERNELS)
    for entry in out:
        assert entry["shape"] == [4, 16, 64, 40, 8] and (entry["g"], entry["C"]) == (16, C)
        assert entry["launches"] == 8 and list(entry["shapes"].values()) == [6, 2]
        assert entry["ms"] is None and entry["bound_by"] == "bytes" and entry["bound_ms"] > 0
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(entry)
        assert (ROOT / entry["source"]).exists()


def test_decode_bound_at_the_chat_shape_is_bytes():
    """olmo_1b.chat's step: 168 MB of bf16 K and V a layer, ~50 us."""
    ms, by = chip_smoke.decode_bound_ms(32, 640, 16, 1, 128, "bfloat16")
    assert by == "bytes"
    kv_bytes = 2 * 32 * 640 * 16 * 128 * 2
    assert ms == pytest.approx((kv_bytes + 2 * 32 * 16 * 128 * 2 + 4 * 640) / 3.35e12 * 1e3)
    assert 0.050 < ms < 0.0505
    assert chip_smoke.DECODE_SHAPES[0] == ((32, 640, 16, 1, 128), "bfloat16", None)


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
    and the four serve-restore cases against zlib only; no device times off
    the card."""
    out = chip_smoke.phase_crc32(torch.device("cpu"),
                                 shapes=[(1, 1), (3, 7), (2, 8)],
                                 long=(2, 300),
                                 serve=((3, 1001), (2, 1003), (3, 1005), (1, 1007)))
    assert [c["shape"] for c in out] == [[1, 1], [3, 7], [2, 8], [2, 300], [3, 1001],
                                         [2, 1003], [3, 1005], [1, 1007]]
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
    decode = chip_smoke.decode_entry(cpu, 32, {(2, 40, 4, 1, 32, 1, "float32"): 32})
    assert decode["shape"] == [2, 40, 4, 1, 32] and decode["launches"] == 32
    assert decode["shapes"] == {"[2, 40, 4, 1, 32, 1, 'float32']": 32}
    assert decode["max_abs_err"] == 0.0 and decode["ms"] is None
    for entry in (crc, flash, decode):
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
    # the checkpoint again, through reshard_restore onto a 1 x 1 gloo mesh
    r = out["reshard"]
    assert r["step"] == 3 and r["mesh"] == {"data": 1, "model": 1}
    from repro_torch.models import get_model
    from repro_torch.train.step import make_train_state_abstract
    from repro_torch.tree import flatten_with_path
    assert r["leaves_bit_equal"] == len(flatten_with_path(
        make_train_state_abstract(get_model(tiny_olmo(), "cpu"))))
    assert r["crc_launches"] == 0 and r["loss_bitwise_equal"]
    assert r["loss"] == out["resumed_losses"][0]
    assert sorted(r["placements"]) == sorted(chip_smoke.RESHARD_LEAVES)
    assert all(p == ["Replicate()", "Replicate()"] for p in r["placements"].values())
    import torch.distributed as dist
    assert not dist.is_initialized()  # the phase's group is gone


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


# ------------------------------------------------ MoE and head_dim 256 phases
def tiny_granite():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite_moe_3b").scaled_down(),
                               **chip_smoke.GRANITE_K8)


def test_serve_granite_moe_phase_on_cpu():
    """The serve_granite_moe phase on granite's scaled-down config at k = 8
    in groups of 16: tokens equal through a preemption, the parameter
    count checked, and the probe's count of the prefill's dropped pairs."""
    out = chip_smoke.run_serve_granite_moe(torch.device("cpu"), cfg=tiny_granite(),
                                           batch=2, prompt_len=32, tokens=6,
                                           snapshot_every=2, crash_at=3)
    assert out["tokens_equal"] and out["prefills"] == 2
    assert out["params"] == out["config_param_count"] + (2 * 4 + 1) * 128
    probe = out["probe"]
    # C = ceil(16 · 8 / 16 · 1.25) = 10, rounded up to a multiple of 4
    assert probe["calls"] == 4 and probe["group"] == 16 and probe["capacity"] == 12
    assert probe["pairs"] == 4 * 2 * 32 * 8 and 0 <= probe["dropped"] < probe["pairs"]
    assert out["flash_attention"]["launches"] == 0  # the CPU runs the plain version
    # one routing a MoE layer a prefill; the CPU launches no MoE kernel
    assert out["moe_layers"] == probe["calls"] and out["decode_steps"] > 0
    assert all(out[name]["launches"] == 0 for name in chip_smoke.MOE_KERNELS)


def test_serve_gemma3_12b_phase_on_cpu():
    """The serve_gemma3_12b phase on gemma3_12b's scaled-down config at
    head_dim 256, a prompt past its 64-token window."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("gemma3_12b").scaled_down(), head_dim=256)
    out = chip_smoke.run_serve_gemma3_12b(torch.device("cpu"), cfg=cfg, prompt_len=80,
                                          tokens=6, snapshot_every=2, crash_at=3)
    assert out["tokens_equal"] and out["attn_pattern"] == "local_global"
    # ['local']['k'] is (1, 5, 1, 64, 2, 256) bf16
    assert out["largest_cache_leaf_bytes"] == 5 * 64 * 2 * 256 * 2
    assert out["probe"] is None


@pytest.mark.parametrize("label", ["granite_moe", "mixtral", "gemma3_12b"])
def test_model_check_on_cpu_for_moe_and_head_dim_256(label):
    kwargs = dict(chip_smoke.MODEL_CHECKS[label],
                  prompt_len={"granite_moe": 32, "mixtral": 72, "gemma3_12b": 72}[label])
    out = chip_smoke.run_model_check(torch.device("cpu"), batch=1, steps=2, **kwargs)
    assert out["max_abs_err"] == 0.0 and out["routing_flips"] == []
    assert out["moe_routing_calls"] == (0 if label == "gemma3_12b" else 4 * 3)


@pytest.mark.parametrize("label", ["granite_moe", "mixtral"])
def test_train_check_on_cpu_for_moe(label):
    kwargs = dict(chip_smoke.TRAIN_CHECKS[label], seqs=(32,) if label == "granite_moe" else (72,))
    out = chip_smoke.run_train_check(torch.device("cpu"), **kwargs)
    assert out["max_abs_err"] == 0.0 and out["routing_flips"] == []


def fake_call(topi, keep, gates):
    """One logged routing call (B = n = 1) from per-token lists."""
    topi = torch.tensor(topi)[None, None]
    return (topi, torch.zeros_like(topi), torch.tensor(keep)[None, None],
            torch.tensor(gates)[None, None])


def test_routing_flip_passes_near_ties_only():
    gates = [[0.5, 0.25, 0.25 - 5e-7, 0.0], [0.1, 0.2, 0.3, 0.4]]
    same = fake_call([[0, 1], [3, 2]], [[True, True], [True, True]], gates)
    assert chip_smoke.routing_flip(same, same) is None
    # the same experts in another order, the keep-mask following them: no flip
    swapped = fake_call([[1, 0], [3, 2]], [[True, True], [True, True]], gates)
    assert chip_smoke.routing_flip(swapped, same) is None
    partly = fake_call([[0, 1], [3, 2]], [[True, False], [True, True]], gates)
    assert chip_smoke.routing_flip(
        fake_call([[1, 0], [3, 2]], [[False, True], [True, True]], gates), partly) is None
    # the card took expert 2 for token 0 where the CPU took 1: 5e-7 apart
    card = fake_call([[0, 2], [3, 2]], [[True, True], [True, False]], gates)
    flip = chip_smoke.check_flip(chip_smoke.routing_flip(card, same), "test")
    assert flip["tokens"] == 1 and flip["keep_faults"] == 0
    assert flip["max_gate_gap"] == pytest.approx(5e-7, rel=0.05)  # float32 gates
    # a flip between gates 0.1 apart is a fault
    far = fake_call([[0, 1], [3, 0]], [[True, True], [True, True]], gates)
    with pytest.raises(RuntimeError, match="no near tie"):
        chip_smoke.check_flip(chip_smoke.routing_flip(far, same), "test")
    # the same experts with another keep-mask is a fault too
    with pytest.raises(RuntimeError, match="no near tie"):
        chip_smoke.check_flip(chip_smoke.routing_flip(partly, same), "test")


def test_routing_replay_routes_as_the_card_did(monkeypatch):
    """A CPU run that replays another run's routing: a token routed to
    another expert in the first call is a fault unless a near tie; let
    through, the replay routes as the other run did and computes its
    logits exactly; the flips count against ``MAX_FLIPS``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.models import get_model
    from repro_torch.models.layers import moe as M
    cfg = dataclasses.replace(get_config("granite_moe_3b").scaled_down(), dtype="float32",
                              **chip_smoke.GRANITE_K8)
    model = get_model(cfg, torch.device("cpu"))
    params = model.init(0)
    prompts = {k: torch.as_tensor(v) for k, v in make_batch(
        cfg, ShapeConfig("t", 32, 1, "prefill")).items()}
    top_k, calls = M.top_k, []

    def swap_first(gates, k):  # the first call sends token 0 to its (k+1)-th expert
        _v, i = top_k(gates, k + 1)
        if not calls:
            i = i.clone()
            i[0, 0, 0, k - 1] = i[0, 0, 0, k]
        calls.append(1)
        i = i[..., :k]
        return gates.gather(-1, i), i
    with torch.inference_mode():
        monkeypatch.setattr(M, "top_k", swap_first)
        with chip_smoke.RoutingLog() as card:
            card_logits, _ = model.prefill(params, prompts)
        monkeypatch.setattr(M, "top_k", top_k)
        with pytest.raises(RuntimeError, match="no near tie"):
            with chip_smoke.RoutingLog(replay=card.calls):
                model.prefill(params, prompts)
        monkeypatch.setattr(chip_smoke, "NEAR_TIE", 1.0)
        with chip_smoke.RoutingLog(replay=card.calls) as cpu:
            logits, _ = model.prefill(params, prompts)
        own, _ = model.prefill(params, prompts)
    assert [(f["call"], f["tokens"]) for f in cpu.flips] == [(0, 1)]
    assert torch.equal(logits, card_logits) and not torch.equal(own, card_logits)
    assert chip_smoke.check_routing(card, cpu, "test") == cpu.flips
    monkeypatch.setattr(chip_smoke, "MAX_FLIPS", 0)
    with pytest.raises(RuntimeError, match="more than 0"):
        chip_smoke.check_routing(card, cpu, "test")


def test_new_flash_shapes_run_on_cpu():
    """The new FLASH_SHAPES rows (granite's prefill layer, gemma3_12b's
    global layer, hd-256 edges and the f32 hd-256 route) through the flash
    phase on the CPU, plain against plain, at most 8 heads each."""
    new = [row for row in chip_smoke.FLASH_SHAPES
           if row[0][2] == 256 or row[0] == (96, 1024, 64)]
    assert [(s, dt, c) for s, dt, c in new] == [
        ((96, 1024, 64), "bfloat16", True), ((16, 1536, 256), "bfloat16", True),
        ((16, 65, 256), "bfloat16", True), ((16, 100, 256), "bfloat16", False),
        ((3, 192, 256), "float32", True)]
    small = [((min(bh, 8), s, hd), dt, c) for (bh, s, hd), dt, c in new]
    out = chip_smoke.run_flash_attention(torch.device("cpu"), shapes=small)
    assert [c["max_abs_err"] for c in out] == [0.0] * 5
    assert all(c["tol"] == chip_smoke.FLASH_TOL[c["dtype"]] for c in out)


def test_granite_and_gemma3_12b_prefill_flash_keys():
    """A serve_granite_moe prefill runs flash on all 32 layers at (4 x 24
    heads, 1024, 64); a serve_gemma3_12b prefill on its 8 global layers at
    (16 heads, 1536, 256).  The bounds of one call: operations, at 989
    TFLOP/s."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_plan
    g = get_config("granite_moe_3b")
    assert chip_smoke.GRANITE_PREFILL_FLASH == {(4 * g.n_heads, 1024, g.head_dim,
                                                 "bfloat16"): g.n_layers}
    assert g.param_count() == 3_298_693_632
    c = get_config("gemma3_12b")
    assert layer_plan(c).count("full") == 8 and c.head_dim == 256
    assert chip_smoke.GEMMA3_12B_PREFILL_FLASH == {(c.n_heads, 1536, 256, "bfloat16"): 8}
    ms, by = chip_smoke.flash_bound_ms(16, 1536, 256, "bfloat16", True)
    assert by == "operations"
    assert ms == pytest.approx(4 * 16 * 1536**2 * 256 / 2 / 989e12 * 1e3)


def test_kernels_line_reports_the_head_dim_256_shape():
    cpu = torch.device("cpu")
    flash = chip_smoke.flash_entry(cpu, 4, {(2, 40, 32, "float32"): 3,
                                            (1, 24, 256, "bfloat16"): 1},
                                   also=[(1, 24, 256, "bfloat16")])
    assert flash["shape"] == [2, 40, 32] and flash["launches"] == 4
    (hd256,) = flash["also"]
    assert hd256["shape"] == [1, 24, 256] and hd256["launches"] == 1
    assert hd256["max_abs_err"] == 0.0 and hd256["ms"] is None
    assert {"bound_ms", "bound_by", "plain_ms", "library_ms"} <= set(hd256)


# ------------------------------------------- the rwkv, hybrid and encdec phases
#: narrow widths for the serve rehearsals: their restores run the plain CRC
TINY_WIDTHS = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                   vocab_size=64)
#: each new serve phase, its config's narrowing, and its largest cache leaf
#: at 2 requests x 16 tokens
NEW_SERVE = {
    "rwkv6": (chip_smoke.run_serve_rwkv6, "rwkv6_1p6b", {},
              "['layers']['tm']['h']", 4 * 2 * 2 * 32 * 32 * 4),
    "zamba2": (chip_smoke.run_serve_zamba2, "zamba2_1p2b",
               dict(n_layers=5, shared_attn_every=2, ssm_head_dim=16, ssm_state=8),
               "['attn']['k']", 2 * 2 * (16 + 128) * 2 * 16 * 2),
    "whisper": (chip_smoke.run_serve_whisper, "whisper_small",
                dict(n_layers=2, encoder_layers=1), "['self']['k']",
                2 * 2 * (16 + 128) * 2 * 16 * 2)}


@pytest.mark.parametrize("label", sorted(NEW_SERVE))
def test_new_serve_phases_on_cpu(label):
    """Each new serve phase on its family's scaled-down config (zamba2 with
    a tail), narrowed: tokens equal through a preemption, the exact
    parameter count checked, no flash launch off the card."""
    from repro_torch.configs import get_config
    run, arch, extra, leaf, nbytes = NEW_SERVE[label]
    cfg = dataclasses.replace(get_config(arch).scaled_down(), **TINY_WIDTHS, **extra)
    out = run(torch.device("cpu"), cfg=cfg, batch=2, prompt_len=16, tokens=6,
              snapshot_every=2, crash_at=3)
    assert out["tokens_equal"] and out["prefills"] == 2
    assert out["params"] == out["exact_param_count"] == chip_smoke.exact_param_count(cfg)
    assert out["largest_cache_leaf"] == leaf and out["largest_cache_leaf_bytes"] == nbytes
    assert out["flash_attention"]["launches"] == 0
    assert out["max_memory_allocated"] is None


@pytest.mark.parametrize("label", ["rwkv6", "zamba2", "whisper"])
def test_model_check_on_cpu_for_the_new_families(label):
    out = chip_smoke.run_model_check(torch.device("cpu"), batch=1, steps=2,
                                     **chip_smoke.MODEL_CHECKS[label])
    assert out["max_abs_err"] == 0.0
    assert out["family"] == {"rwkv6": "ssm", "zamba2": "hybrid", "whisper": "encdec"}[label]


def reference_param_count(arch, **kw):
    """Elements of the JAX package's ``init`` tree, from its shapes only."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.models import get_model as j_get_model
    cfg = dataclasses.replace(j_get_config(arch), **kw)
    tree = jax.eval_shape(lambda: j_get_model(cfg).init(jax.random.PRNGKey(0)))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch,kw", [
    ("rwkv6_1p6b", {}), ("zamba2_1p2b", {}), ("whisper_small", {}),
    ("zamba2_1p2b", dict(n_layers=5, shared_attn_every=2, d_model=128)),
    ("rwkv6_1p6b", dict(n_layers=2, d_model=128, n_heads=4, d_ff=256)),
    ("whisper_small", dict(encoder_layers=3, n_layers=2, tie_embeddings=False)),
    ("olmo_1b", {}), ("gemma3_27b", {}), ("granite_moe_3b", {})])
def test_exact_param_count_equals_the_reference_tree(arch, kw):
    """The closed form against the JAX package's ``jax.eval_shape(init)``
    tree (max_seq 4096, its default) and the port's own on the meta device;
    ``ModelConfig.param_count`` is approximate for the new families."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.tree import flatten_with_path
    cfg = dataclasses.replace(get_config(arch), **kw)
    want = reference_param_count(arch, **kw)
    assert chip_smoke.exact_param_count(cfg) == want
    port = get_model(cfg, "cpu").init_abstract()
    assert sum(t.numel() for _p, t in flatten_with_path(port)) == want
    if cfg.family in ("ssm", "hybrid", "encdec") and not kw:
        assert want != cfg.param_count()


def test_full_config_exact_param_counts():
    from repro_torch.configs import get_config
    counts = {a: chip_smoke.exact_param_count(get_config(a))
              for a in ("rwkv6_1p6b", "zamba2_1p2b", "whisper_small")}
    assert counts == {"rwkv6_1p6b": 1_449_725_952, "zamba2_1p2b": 1_104_777_344,
                      "whisper_small": 241_206_528}


def restore_row_words(shape, dtype: str) -> int:
    """Words of one CRC row of a cache leaf's page record: the record
    header (11 B) and key (8 B), the leaf's header length (4 B), its JSON
    header and its bytes, padded to whole words."""
    import json
    import math
    meta = json.dumps({"dtype": dtype, "shape": list(shape)})
    item = {"bfloat16": 2, "float32": 4, "int32": 4}[dtype]
    return (11 + 8 + 4 + len(meta) + math.prod(shape) * item + 3) // 4


@pytest.mark.parametrize("arch,batch,prompt_len,want", [
    ("olmo_1b", 4, 256, chip_smoke.SERVE_RESTORE_CRC),
    ("granite_moe_3b", 4, 1024, chip_smoke.GRANITE_RESTORE_CRC),
    ("rwkv6_1p6b", 4, 1024, chip_smoke.RWKV6_RESTORE_CRC),
    ("zamba2_1p2b", 4, 1024, chip_smoke.ZAMBA2_RESTORE_CRC),
    ("whisper_small", 4, 64, chip_smoke.WHISPER_RESTORE_CRC)])
def test_restore_crc_widths_follow_the_cache_trees(arch, batch, prompt_len, want):
    """Each serve phase's widest restore row, from its family's cache tree
    on the meta device (``launch.serve.snapshot_pages``'s tree); the new
    phases' row counts are their caches' leaf counts."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import family_module
    from repro_torch.tree import flatten_with_path
    cfg = get_config(arch)
    tree = family_module(cfg).init_cache(cfg, batch, prompt_len, device="meta")
    leaves = flatten_with_path(tree)
    widest = max(restore_row_words(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                 for _p, t in leaves)
    assert widest == want[1]
    if cfg.family in ("ssm", "hybrid", "encdec"):
        assert want[0] == len(leaves)
    assert want in chip_smoke.phase_crc32.__kwdefaults__["serve"]


def test_zamba2_and_whisper_prefill_flash_keys_and_bounds():
    """zamba2: the shared block once a group, 4 requests x 32 heads at 1024
    tokens; whisper: 12 encoder layers (not causal) at 1500 frames and 12
    decoder layers at 64 tokens, 4 x 12 heads; rwkv6: none."""
    from repro_torch.configs import get_config
    z, w = get_config("zamba2_1p2b"), get_config("whisper_small")
    G = z.n_layers // z.shared_attn_every
    assert (G, z.n_layers - G * z.shared_attn_every) == (6, 2)
    assert chip_smoke.ZAMBA2_PREFILL_FLASH == {(4 * z.n_heads, 1024, z.head_dim,
                                                "bfloat16"): G}
    assert chip_smoke.WHISPER_PREFILL_FLASH == {
        (4 * w.n_heads, w.encoder_seq, w.head_dim, "bfloat16"): w.encoder_layers,
        (4 * w.n_heads, 64, w.head_dim, "bfloat16"): w.n_layers}
    assert chip_smoke.NON_CAUSAL_FLASH == {(48, 1500, 64, "bfloat16")}
    assert chip_smoke.RWKV6_PREFILL_FLASH == {}
    for shape, dtype, causal in (((128, 1024, 64), "bfloat16", True),
                                 ((48, 1500, 64), "bfloat16", False),
                                 ((48, 64, 64), "bfloat16", True)):
        assert (shape, dtype, causal) in chip_smoke.FLASH_SHAPES
    ms, by = chip_smoke.flash_bound_ms(48, 1500, 64, "bfloat16", False)
    assert by == "operations"
    assert ms == pytest.approx(4 * 48 * 1500**2 * 64 / 989e12 * 1e3)
    ms, by = chip_smoke.flash_bound_ms(48, 64, 64, "bfloat16", True)
    assert by == "bytes"


def test_kernels_line_times_a_non_causal_key_without_the_mask(monkeypatch):
    """A main-path key in ``NON_CAUSAL_FLASH`` (whisper's encoder) is timed
    as its path launches it, without the causal mask."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(chip_smoke, "NON_CAUSAL_FLASH", {(2, 30, 32, "float32")})
    flash = chip_smoke.flash_entry(cpu, 5, {(2, 30, 32, "float32"): 3,
                                            (1, 8, 32, "float32"): 2},
                                   also=[(1, 8, 32, "float32")])
    assert flash["shape"] == [2, 30, 32] and flash["causal"] is False
    (other,) = flash["also"]
    assert other["causal"] is True and other["launches"] == 2


# ------------------------------------------------------- the DES phases
#: the DES phases at a tiny size: few keys and ops, short horizons, a
#: shortened chaos and elastic run
TINY_YCSB = dict(n_keys=100, n_ops=200, value_size=64, threads=4, n_shards=4)
TINY_FAILOVER = dict(chip_smoke.FAILOVER, n_ops=100, n_keys=20)


def test_des_check_on_cpu():
    """The DES workloads against themselves on the CPU: every pair of reports
    equal as sorted JSON, and no launch off the card."""
    out = chip_smoke.run_des_check(torch.device("cpu"), n_keys=40, n_ops=100,
                                   failover=TINY_FAILOVER, at_load_horizon_s=0.001)
    assert sorted(out) == ["at_load_120", "at_load_900", "failover", "ycsb_a_batch16",
                           "ycsb_c"]
    assert all(r["equal"] and r["crc_launches"] == 0 for r in out.values())


def test_ycsb_phase_on_cpu():
    """The paper's anchors at their full size (simulated µs, Table 1 bytes),
    YCSB A, B, C and B at batch 16 and the three fault workloads at a tiny
    size: every read checked, no lost acknowledged write, no stale read."""
    out = chip_smoke.run_ycsb(torch.device("cpu"), ycsb=TINY_YCSB, failover=TINY_FAILOVER,
                              chaos=dict(n_ops=60, n_keys=12, n_faults=2),
                              elastic=dict(n_ops=120, n_keys=30), profile_ops=20)
    a = out["anchors"]
    assert a["mean_read_us"]["erda"] == pytest.approx(62.0, abs=4.0)
    assert a["mean_read_us"]["redo"] == pytest.approx(92.0, abs=4.0)
    assert a["server_cpu_us_at"]["erda"]["read"] == 0.0
    t1 = a["table1_nvm_bytes"][1024]
    assert t1["redo"]["measured"] == t1["redo"]["table1"] == [2084, 2068, 16]
    assert t1["erda"]["measured"] == [1061, 1051, 27]  # the 11 B header's framing
    assert t1["erda_redo_update_ratio"] == pytest.approx(0.508, abs=1e-3)
    assert [(r["workload"], r["batch_size"]) for r in out["ycsb"]] == list(chip_smoke.YCSB_RUNS)
    assert all(r["reads"] + r["writes"] == 200 for r in out["ycsb"])
    assert sorted(out["faults"]) == ["chaos", "elastic", "failover"]
    assert all(f["lost_acked_writes"] == 0 == f["stale_reads"] for f in out["faults"].values())
    assert out["faults"]["failover"]["failovers"] == 1
    assert out["crc32_batch"]["launches"] == 0 and out["profiled"]["crc_kernel_ms"] is None


def test_serve_at_load_phase_on_cpu():
    """Every run of the phase at short horizons: the p99 opens past the
    knee, deadline admission keeps goodput, the shared-QP schedules are
    legal, and each geometry is captured once."""
    out = chip_smoke.run_serve_at_load(
        torch.device("cpu"), at_load=dict(chip_smoke.AT_LOAD, horizon_s=0.004),
        slo=dict(chip_smoke.AT_LOAD_SLO, horizon_s=0.002, capture_batches=(1, 2, 4, 8, 16)),
        page_vsize=512)
    runs = out["runs"]
    assert list(runs) == ["120_per_op", "120_coalesced", "900_per_op", "900_coalesced",
                          "400_queue", "400_slo", "3840_queue", "3840_slo",
                          "120_page512", "900_page512"]
    assert [r["captured"] for r in runs.values()].count(True) == 3
    assert runs["900_coalesced"]["p99_us"] > runs["120_coalesced"]["p99_us"]
    assert runs["3840_slo"]["goodput_kops"] >= runs["3840_queue"]["goodput_kops"]
    assert all(runs[k]["schedule_violations"] == 0 for k in runs if "queue" in k or "slo" in k)
    assert len(runs["900_coalesced"]["nic_utilization"]) == 2


def test_report_json_is_canonical():
    a = {2: (1, b"\x01"), "x": [0.5, None], 1: {"k": True}}
    b = {1: {"k": True}, "x": [0.5, None], 2: [1, b"\x01"]}
    assert chip_smoke.report_json(a) == chip_smoke.report_json(b)
    assert chip_smoke.report_json(a) != chip_smoke.report_json({**a, "x": [0.25, None]})


def test_des_crc_keys_pick_single_and_batched_reads():
    """At a 1 KiB record's and an 8 KiB page's width, the most launched
    batch and the one with the most rows; other widths are left out."""
    assert chip_smoke.DES_CRC_WIDTHS == (261, 2053)
    shapes = {(1, 261): 900, (16, 261): 20, (3, 261): 40, (1, 21): 5000,
              (9, 2053): 4, (12, 2053): 1}
    assert chip_smoke.des_crc_keys(shapes) == [(1, 261), (16, 261), (9, 2053), (12, 2053)]
    assert chip_smoke.des_crc_keys({(2, 261): 3}) == [(2, 261)]


def test_kernels_line_reports_the_des_crc_batches():
    cpu = torch.device("cpu")
    crc = chip_smoke.crc_entry(cpu, 9, {(6, 2): 2, (2, 21): 7}, also=[(2, 21)],
                               also_shapes={(2, 21): 7})
    assert crc["shape"] == [6, 2] and crc["launches"] == 9
    (des,) = crc["also"]
    assert des["shape"] == [2, 21] and des["launches"] == 7 and des["max_abs_err"] == 0
    assert {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "verify_call_ms",
            "zlib_ms"} <= set(des)
    assert des["verify_call_ms"] > 0 and des["ms"] is None


def test_des_phases_run_before_serving():
    """The DES phases follow the checkpoint phase and precede serve."""
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = [src.index(f'"{name}"') for name in ("checkpoint", "ycsb", "serve_at_load",
                                                 "serve_gemma3")]
    assert order == sorted(order)


def test_dryrun_phase_runs_after_train_and_before_kernels():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    assert "train,dryrun,kernels" in src
    order = [src.index(f'"{name}" in phases') for name in ("dryrun", "kernels")]
    assert order == sorted(order)


def test_dryrun_summary_pairs_the_measured_step_with_the_roofline():
    rec = {"arch": "olmo_1b", "shape": "train_phase", "mesh": "one", "chips": 1,
           "layers": 8, "compute_s": 0.045, "memory_s": 0.32, "collective_s": 0.0,
           "dominant": "memory", "roofline_fraction": 0.099, "useful_fraction": 0.70,
           "hlo_flops_total": 4.47e13, "model_flops": 3.15e13,
           "collective_bytes_per_chip": 0.0, "bytes_per_device": {}, "lower_s": 5.6}
    out = chip_smoke.dryrun_summary(rec, 520.0)
    assert out["roofline_ms"] == pytest.approx(320.0)
    assert out["measured_over_roofline"] == pytest.approx(520.0 / 320.0)
    assert chip_smoke.dryrun_summary(rec)["measured_over_roofline"] is None
    rec["collective_s"] = 0.5  # the largest term is the critical path
    assert chip_smoke.dryrun_summary(rec, 1000.0)["measured_over_roofline"] == \
        pytest.approx(2.0)


def test_dryrun_phase_on_cpu(tmp_path):
    """The phase at a tiny size: a decode cell on the 16 x 16 fake mesh and
    one olmo_1b layer at 2 x 64 on a 1-GPU mesh, in subprocesses."""
    out = chip_smoke.run_dryrun(torch.device("cpu"), train={"step_ms_median_2_on": 100.0},
                                cell=("olmo_1b", "decode_32k", "single"), layers=1,
                                batch=2, seq=64, out_dir=tmp_path)
    cell, phase = out["cell"], out["train_phase"]
    assert cell["ok"] and cell["chips"] == 256 and cell["shape"] == "decode_32k"
    assert cell["collective_bytes_per_chip"] > 0
    assert phase["chips"] == 1 and phase["layers"] == 1 and phase["collective_s"] == 0
    assert phase["measured_over_roofline"] == pytest.approx(100.0 / phase["roofline_ms"])
    assert phase["dominant"] in ("compute", "memory")


# ------------------- serve_pixtral, train_families and the examples phase
def tiny_vlm():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("pixtral_12b").scaled_down(), d_model=64,
                               n_heads=2, n_kv_heads=1, head_dim=32, d_ff=64, vocab_size=64)


def test_serve_pixtral_phase_on_cpu():
    """The serve_pixtral phase on a narrowed vlm: its 8 patches go before
    the 16 tokens, the tokens are equal through a preemption, and the
    parameters number the family's exact count (mistral_nemo_12b's is
    checked at the full config only)."""
    out = chip_smoke.run_serve_pixtral(torch.device("cpu"), cfg=tiny_vlm(), prompt_len=16,
                                       tokens=6, snapshot_every=2, crash_at=3)
    assert out["tokens_equal"] and out["prefills"] == 2 and out["batch"] == 1
    assert out["params"] == out["exact_param_count"]
    assert out["mistral_nemo_12b_params"] is None and out["n_patches"] == 8
    # ['full']['k'] is (4 layers, 1, 8 + 16 + 128, 1, 32) bf16
    assert out["largest_cache_leaf"] == "['full']['k']"
    assert out["largest_cache_leaf_bytes"] == 4 * (8 + 16 + 128) * 32 * 2
    assert out["flash_attention"]["launches"] == 0 and out["max_memory_allocated"] is None


def test_pixtral_prefill_flash_key_and_bound():
    """A serve_pixtral prefill runs flash on all 40 layers at (1 x 32 heads,
    256 + 1024, 128): 1280 positions, 20 of the bf16 kernel's 64-key tiles;
    the bound of one call is its operations at 989 TFLOP/s."""
    from repro_torch.configs import get_config
    c = get_config("pixtral_12b")
    S = c.n_patches + 1024
    assert S == 1280 and S % 64 == 0
    assert chip_smoke.PIXTRAL_PREFILL_FLASH == {(c.n_heads, S, c.head_dim, "bfloat16"):
                                                c.n_layers}
    assert ((32, 1280, 128), "bfloat16", True) in chip_smoke.FLASH_SHAPES
    ms, by = chip_smoke.flash_bound_ms(32, 1280, 128, "bfloat16", True)
    assert by == "operations"
    assert ms == pytest.approx(4 * 32 * 1280**2 * 128 / 2 / 989e12 * 1e3)
    assert chip_smoke.PIXTRAL_RESTORE_CRC in chip_smoke.phase_crc32.__kwdefaults__["serve"]


def test_pixtral_restore_crc_width_follows_its_cache_tree():
    """The serve_pixtral restore's widest row: the ['full']['k'] leaf of a
    1280-position cache (patches and tokens); as many rows as leaves."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import family_module
    from repro_torch.tree import flatten_with_path
    cfg = get_config("pixtral_12b")
    leaves = flatten_with_path(family_module(cfg).init_cache(cfg, 1, 1280, device="meta"))
    widest = max(restore_row_words(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                 for _p, t in leaves)
    assert (len(leaves), widest) == chip_smoke.PIXTRAL_RESTORE_CRC


def test_full_pixtral_decoder_is_mistral_nemo_12b():
    """pixtral_12b's decoder has mistral_nemo_12b's widths, so one serve_pixtral
    phase runs every shape of mistral_nemo_12b's text path."""
    from repro_torch.configs import get_config
    pix, nemo = get_config("pixtral_12b"), get_config("mistral_nemo_12b")
    same = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
            "vocab_size", "rope_theta", "tie_embeddings", "attn_pattern", "dtype")
    assert {k: getattr(pix, k) for k in same} == {k: getattr(nemo, k) for k in same}
    assert chip_smoke.exact_param_count(pix) == chip_smoke.exact_param_count(nemo) \
        == 11_576_693_760


def tiny_family_configs():
    """Every train_families config scaled down and narrowed (zamba2 with a
    tail), 16 decoder tokens a row."""
    from repro_torch.configs import get_config
    extra = {"zamba2_1p2b": dict(n_layers=5, shared_attn_every=2, ssm_head_dim=16, ssm_state=8),
             "whisper_small": dict(d_model=32, head_dim=16)}
    out = {}
    for name in chip_smoke.TRAIN_FAMILIES:
        widths = dict(TINY_WIDTHS, **extra.get(name, {}))
        out[name] = (dataclasses.replace(get_config(name).scaled_down(), **widths), 16)
    return out


def test_train_families_phase_on_cpu():
    """The phase on every family scaled down: 3 steps each, finite losses,
    no flash launch; whisper saves after step 1 and a fresh trainer's
    resumed losses are the uninterrupted run's; the cut depths listed."""
    out = chip_smoke.run_train_families(torch.device("cpu"), configs=tiny_family_configs(),
                                        steps=3, ckpt_at=1)
    assert list(out) == list(chip_smoke.TRAIN_FAMILIES)
    assert [r["family"] for r in out.values()] == ["moe", "dense", "vlm", "ssm", "hybrid",
                                                   "encdec"]
    for name, r in out.items():
        assert len(r["losses"]) == 3 and r["flash_launches"] == 0, name
        assert r["max_memory_allocated"] is None and r["profiled_step"]["busy_share"] is None
        assert r["reduced"]["n_layers"][1] == r["layers"] or r["reduced"]["n_layers"][0] == \
            r["layers"]
        assert (r["resume"] is not None) == (name == chip_smoke.TRAIN_FAMILY_CKPT)
        assert r["moe_launches"] == dict.fromkeys(chip_smoke.MOE_KERNELS, 0), name
    w = out["whisper_small"]
    assert w["tokens_per_step"] == 2 * (16 + 32)  # 32 stub frames a row
    res = w["resume"]
    assert res["resumed_bitwise_equal"] and res["resumed_losses"] == w["losses"][1:]
    assert res["save_shards"] > 0 and res["restore_crc_launches"] == 0
    assert res["restore_crc_case"] is None  # no device times off the card
    assert out["pixtral_12b"]["positions_per_row"] == 8 + 16


def test_train_families_hold_every_kind_of_layer():
    """The cut depths at full width: granite all MoE; gemma3_12b one 5:1
    local:global unit and no tail; zamba2 one group of 6 Mamba2 layers with
    the shared block and the 2-layer tail; whisper whole; 4 steps of 2 rows;
    only whisper's 2.4 GB state checkpoints."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_plan
    cut = {n: dataclasses.replace(get_config(n), **s["overrides"])
           for n, s in chip_smoke.TRAIN_FAMILIES.items()}
    assert layer_plan(cut["gemma3_12b"]).count("full") == 1
    assert layer_plan(cut["gemma3_12b"]).count("window") == 5
    z = cut["zamba2_1p2b"]
    assert (z.n_layers // z.shared_attn_every, z.n_layers % z.shared_attn_every) == (1, 2)
    assert cut["whisper_small"] == get_config("whisper_small")
    assert cut["granite_moe_3b"].n_experts == 40 and cut["granite_moe_3b"].n_layers == 2
    assert {n: s["seq"] for n, s in chip_smoke.TRAIN_FAMILIES.items()} == {
        "granite_moe_3b": 2048, "gemma3_12b": 2048, "pixtral_12b": 2048,
        "rwkv6_1p6b": 2048, "zamba2_1p2b": 2048, "whisper_small": 448}
    assert (chip_smoke.TRAIN_FAMILY_STEPS, chip_smoke.TRAIN_FAMILY_BATCH) == (4, 2)
    state = 10 * chip_smoke.exact_param_count(cut[chip_smoke.TRAIN_FAMILY_CKPT])
    assert state == pytest.approx(2.41e9, rel=0.01)  # bf16 parameters, f32 moments


def test_train_model_flop_counts_the_positions_each_weight_sees():
    from repro_torch.configs import get_config
    g = dataclasses.replace(get_config("granite_moe_3b"), n_layers=2)
    n = chip_smoke.exact_param_count(g)
    inactive = 2 * (40 - 8) * 3 * 1536 * 512
    assert chip_smoke.train_model_flop(g, n, 2, 2048) == 6 * (n - inactive) * 2 * 2048
    p = dataclasses.replace(get_config("pixtral_12b"), n_layers=2)
    n = chip_smoke.exact_param_count(p)
    assert chip_smoke.train_model_flop(p, n, 2, 2048) == 6 * n * 2 * (256 + 2048)
    w = get_config("whisper_small")
    n = chip_smoke.exact_param_count(w)
    enc = 12 * (2 * 768 + 4 * 768 * 768 + 2 * 768 * 3072) + 768
    assert chip_smoke.train_model_flop(w, n, 2, 448) == 6 * 2 * (enc * 1500 + (n - enc) * 448)


@pytest.mark.parametrize("label", ["rwkv6", "zamba2", "whisper"])
def test_train_check_on_cpu_for_the_new_families(label):
    """The three new train checks (CPU against CPU here) at short sequences
    that still cross a chunk: 24 tokens halve rwkv6's and zamba2's chunk of
    16 to 8."""
    from repro_torch.models.layers.basic import halved_chunk
    kwargs = dict(chip_smoke.TRAIN_CHECKS[label], seqs=(24,))
    out = chip_smoke.run_train_check(torch.device("cpu"), **kwargs)
    assert out["max_abs_err"] <= 1e-6 and out["family"] == {
        "rwkv6": "ssm", "zamba2": "hybrid", "whisper": "encdec"}[label]
    assert halved_chunk(16, 24) == 8
    # on the card: a sequence past the loss's 512-token chunk too
    assert max(chip_smoke.TRAIN_CHECKS[label]["seqs"]) == 640


def test_family_train_checks_run_before_train_families():
    import inspect
    assert set(chip_smoke.FAMILY_TRAIN_CHECKS) == {"rwkv6", "zamba2", "whisper"}
    assert set(chip_smoke.FAMILY_TRAIN_CHECKS) < set(chip_smoke.TRAIN_CHECKS)
    src = inspect.getsource(chip_smoke.main)
    assert '"train_families": [train_check(label) for label in FAMILY_TRAIN_CHECKS]' in src
    assert '"serve_pixtral": [model_check("pixtral")]' in src


def test_new_phases_run_in_order():
    """serve_pixtral after the other serve phases, train_families after
    train, then the examples; every new phase is a default one."""
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = [src.index(f'("{name}", run_') for name in
             ("serve_whisper", "serve_pixtral", "train", "train_families", "examples")]
    assert order == sorted(order)
    defaults = chip_smoke.main.__code__.co_consts
    phases = next(c for c in defaults if isinstance(c, str) and c.startswith("device,"))
    assert {"serve_pixtral", "train_families", "examples"} <= set(phases.split(","))


def test_examples_phase_commands():
    """Each of the five ported examples in the order they run, by path,
    through the runner that prints its kernels' launches after it; at its
    own defaults unless the phase is given arguments."""
    cmds = chip_smoke.example_commands()
    assert list(cmds) == ["quickstart_torch", "elastic_scale_torch", "serve_kv_torch",
                          "failure_recovery_demo_torch", "train_lm_torch"]
    for name, argv in cmds.items():
        assert argv[:2] == [sys.executable, "-c"] and argv[2] == chip_smoke.EXAMPLE_RUNNER
        assert argv[3:] == [f"examples/{name}.py"] and (ROOT / argv[3]).exists()
    assert chip_smoke.example_commands(["train_lm_torch"], ("--device", "cpu"))[
        "train_lm_torch"][3:] == ["examples/train_lm_torch.py", "--device", "cpu"]
    assert chip_smoke.EXAMPLES_READING == set(chip_smoke.EXAMPLES) - {"train_lm_torch"}


def test_examples_phase_on_cpu():
    out = chip_smoke.run_examples(torch.device("cpu"),
                                  names=("quickstart_torch", "elastic_scale_torch"),
                                  args=("--device", "cpu"))
    assert out["args"] == ["--device", "cpu"]
    for name in ("quickstart_torch", "elastic_scale_torch"):
        row = out[name]
        assert row["exit"] == 0 and row["wall_s"] > 0
        assert row["kernels"]["crc32_batch"]["launches"] == 0  # the CPU's plain CRC
        assert row["tail"]
    assert out["elastic_scale_torch"]["tail"][-1].startswith("all 300 keys intact")


def test_kernels_line_reports_the_wide_restore_batches_against_zlib():
    """Batches past ``PLAIN_CRC_WORDS`` (the pixtral restore's, a
    checkpoint restore's 4 MiB shards) stand in the CRC entry's ``also``
    against zlib, with their main-path launches."""
    assert chip_smoke.WIDE_CRC_WIDTHS == (chip_smoke.PIXTRAL_RESTORE_CRC[1], 1048581)
    crc = chip_smoke.crc_entry(torch.device("cpu"), 6, {(6, 2): 2}, also_shapes={(2, 300): 4},
                               wide=[(2, 300)])
    (wide,) = crc["also"]
    assert wide["shape"] == [2, 300] and wide["launches"] == 4
    assert wide["exact_against"] == "zlib" and wide["plain_ms"] is None
    assert wide["bound_by"] == "bytes" and wide["ms"] is None
