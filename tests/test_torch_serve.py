"""The port's serving engine (``repro_torch.serving.ServeEngine``) on the
CPU: a decode preempted mid-stream resumes from the Erda page store
bit-identically (the analogue of the reference's
``test_preemption_recovery_bit_identical``), and the page store's geometry
for a full-size cache.  The restore's CRC verify runs the plain per-byte
version here, about 14 s for this test's 327 KiB cache leaves."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import make_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import get_model
from repro_torch.serving import ServeEngine

CPU = torch.device("cpu")


def f32_cfg(get):
    return dataclasses.replace(get("olmo_1b").scaled_down(), dtype="float32")


def prompts(cfg, seq=32, batch=2):
    return make_batch(cfg, ShapeConfig("t", seq, batch, "prefill"))


def test_preemption_recovery_bit_identical():
    cfg = f32_cfg(get_config)
    model = get_model(cfg, CPU)
    params = model.init(0)
    batch = prompts(cfg)
    clean = ServeEngine(model, params, snapshot_every=4, device=CPU).generate(
        batch, 12, seq_id=1)
    engine = ServeEngine(model, params, snapshot_every=4, device=CPU)
    crashy = engine.generate(batch, 12, seq_id=2, crash_at=6)
    assert clean.shape == (2, 12) and clean.dtype == np.int32
    np.testing.assert_array_equal(clean, crashy)
    assert engine.pages.stats["reads"] > 0  # the recovery read the page store


def test_recovery_without_a_snapshot_raises():
    cfg = f32_cfg(get_config)
    model = get_model(cfg, CPU)
    engine = ServeEngine(model, model.init(0), snapshot_every=0, device=CPU)
    with pytest.raises(RuntimeError, match="no snapshot"):
        engine.generate(prompts(cfg, seq=8, batch=1), 4, crash_at=1)


def test_page_store_segments_hold_a_whole_cache_leaf():
    cfg = get_config("olmo_1b")  # full config: a 96 MiB k leaf at 4 x 384 tokens
    store = tserve.page_store_for(cfg, 4, 256, 16, 8, CPU)
    shard = store.store.cluster.cfg
    leaf = 16 * 4 * (256 + 128) * 16 * 128 * 2
    assert leaf == 96 << 20
    # a segment holds one whole snapshot: the k and v leaves, and beside
    # them the small pages (pos, kv_pos, tokens) and the record headers
    assert 2 * leaf < shard.segment_size <= 2 * leaf + (1 << 20)
    # a shard holds the three snapshots a preempted 16-token run writes,
    # under the atomic word's 31-bit offsets
    assert shard.device_size >= 3 * shard.segment_size
    assert shard.device_size < 1 << 31
    assert len(store.store.cluster.groups) == 2


@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "zamba2_1p2b", "whisper_small"])
def test_launch_serve_on_cpu_for_each_family(arch):
    """``launch.serve.serve`` at the smoke scale (the scaled-down config,
    bf16): a preempted run resumes with the clean run's tokens."""
    kw = dict(arch=arch, batch=1, prompt_len=8, tokens=4, snapshot_every=1, device="cpu")
    clean = tserve.serve(**kw)
    assert clean.shape == (1, 4)
    np.testing.assert_array_equal(clean, tserve.serve(crash_at=2, **kw))


@pytest.mark.parametrize("arch,kw", [
    ("rwkv6_1p6b", {}), ("zamba2_1p2b", {}),
    ("zamba2_1p2b", dict(n_layers=5, shared_attn_every=2)), ("whisper_small", {}),
    ("olmo_1b", {}), ("gemma3_27b", dict(n_layers=8)), ("pixtral_12b", {})])
def test_snapshot_pages_are_the_prefill_caches_leaves(arch, kw):
    """The page store is sized from the family's own cache tree: the pages
    ``snapshot_pages`` lists are the served prefill cache's leaves, by path
    and bytes (a hybrid tail of None has none), and the tokens page."""
    from repro_torch.tree import flatten_with_path
    cfg = dataclasses.replace(get_config(arch).scaled_down(), **kw)
    model = get_model(cfg, CPU)
    batch = prompts(cfg, seq=8, batch=2)
    with torch.inference_mode():
        _l, cache = model.prefill(model.init(0), batch)
    want = [(p, t.numel() * t.element_size()) for p, t in flatten_with_path(cache)]
    assert tserve.snapshot_pages(cfg, 2, 8, 5) == want + [("__tokens__", 4 * 2 * 5)]
