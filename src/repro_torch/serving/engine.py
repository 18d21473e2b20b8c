"""Batched serving engine: prefill a batch of requests, decode greedily, and
snapshot decode state into the Erda page store so that a preempted replica
resumes bit-identically — the port of ``repro/serving/engine.py``'s
``ServeEngine``.  Serving the page store at load (``serve_kv_at_load``)
comes with the port of the DES.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.serving.kv_store import ErdaKVPageStore


class ServeEngine:
    def __init__(self, model, params, *, page_store=None,
                 snapshot_every: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.pages = page_store or ErdaKVPageStore(device=self.device)
        self.snapshot_every = snapshot_every
        self._prefill = model.prefill
        self._decode = model.decode_step

    @torch.inference_mode()
    def generate(self, batch: Dict, n_tokens: int, *, seq_id: int = 0,
                 crash_at: Optional[int] = None) -> np.ndarray:
        """Greedy decode; optionally 'crash' after `crash_at` tokens (state is
        then restored from the Erda page store and decoding continues)."""
        logits, cache = self._prefill(self.params, batch)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [token.cpu().numpy()]
        step = 0
        while len(out) < n_tokens:
            if self.snapshot_every and step % self.snapshot_every == 0:
                self.pages.snapshot_cache(seq_id, cache)
                self.pages.put_page(seq_id, "__tokens__", 0,
                                    np.concatenate(out, axis=1))
            if crash_at is not None and step == crash_at:
                cache = self._recover(seq_id, cache)
                toks = self.pages.get_page(seq_id, "__tokens__", 0).cpu().numpy()
                out = [toks[:, i : i + 1] for i in range(toks.shape[1])]
                crash_at = None
                token = torch.from_numpy(out[-1]).to(self.device)
                continue
            logits, cache = self._decode(self.params, cache, token)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(token.cpu().numpy())
            step += 1
        return np.concatenate(out, axis=1)

    def _recover(self, seq_id: int, template):
        restored = self.pages.restore_cache(seq_id, template)
        if restored is None:
            raise RuntimeError("no snapshot to recover from")
        return restored
