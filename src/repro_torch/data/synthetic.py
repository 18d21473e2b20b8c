"""Deterministic synthetic token pipeline.

Markov-ish structured streams (not uniform noise) so a ~100M model's loss
visibly drops over a few hundred steps in examples/train_lm.py.  Each host
produces only its shard of the global batch (`host_slice`), the multi-host
pattern a 1000-node deployment needs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse random transition table → learnable bigram structure
        self.fanout = 8
        self.table = rng.integers(0, self.vocab_size,
                                  size=(self.vocab_size, self.fanout))

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch(self, step: int):
        rng = np.random.default_rng(
            (self.seed, step, self.host_id, 0xD1CE))
        B, S = self.host_batch, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=B)
        choices = rng.integers(0, self.fanout, size=(B, S))
        for t in range(1, S):
            toks[:, t] = self.table[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}


def make_batch(cfg, shape, step: int = 0, extras: bool = True):
    """Concrete numpy batch matching input_specs(shape) for train/prefill."""
    ds = SyntheticTokens(cfg.vocab_size, shape.seq_len, shape.global_batch)
    batch = ds.batch(step)
    if extras:
        rng = np.random.default_rng(step + 99)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (shape.global_batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (shape.global_batch, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
    return batch
