"""Batched serving engine: prefill a batch of requests, decode greedily, and
snapshot decode state into the Erda page store so that a preempted replica
resumes bit-identically — the port of ``repro/serving/engine.py``.

Also the front door for serving the page store AT LOAD: ``serve_kv_at_load``
drives KV page fetches through the open-loop Poisson driver
(``repro_torch.serving.load``) over the contention-aware DES — offered load
in, throughput + tail latency out.  The page-trace capture runs real
``ErdaCluster`` ops whose clients CRC-verify every fetched page on
``device``; the DES prices the paper's client, not the device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
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
        then restored from the Erda page store and decoding continues).

        Spans (``repro_torch.tracing``): ``serve.generate`` (request
        ``seq_id``) around ``serve.prefill``, ``serve.first_token`` (its
        argmax and copy to the host), each ``serve.snapshot``, the
        ``serve.resume`` after the crash (counting the steps it
        recomputes), and per step ``serve.decode`` (the model call, which
        only enqueues) and ``serve.token`` (argmax and copy: the host waits
        for the card here)."""
        shape = tuple(np.shape(batch["tokens"]))
        with tracing.span("serve.generate", request=seq_id, batch=shape[0],
                          prompt_len=shape[-1], tokens=n_tokens):
            with tracing.span("serve.prefill"):
                logits, cache = self._prefill(self.params, batch)
            with tracing.span("serve.first_token"):
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                out = [token.cpu().numpy()]
            step = 0
            while len(out) < n_tokens:
                if self.snapshot_every and step % self.snapshot_every == 0:
                    with tracing.span("serve.snapshot"):
                        self.pages.snapshot_cache(seq_id, cache)
                        self.pages.put_page(seq_id, "__tokens__", 0,
                                            np.concatenate(out, axis=1))
                if crash_at is not None and step == crash_at:
                    with tracing.span("serve.resume") as sp:
                        cache = self._recover(seq_id, cache)
                        toks = self.pages.get_page(seq_id, "__tokens__", 0).cpu().numpy()
                        sp.add(recomputed=len(out) - toks.shape[1])
                        out = [toks[:, i : i + 1] for i in range(toks.shape[1])]
                        crash_at = None
                        token = torch.from_numpy(out[-1]).to(self.device)
                    continue
                with tracing.span("serve.decode"):
                    logits, cache = self._decode(self.params, cache, token)
                with tracing.span("serve.token"):
                    token = torch.argmax(logits, dim=-1).to(torch.int32)
                    out.append(token.cpu().numpy())
                step += 1
        return np.concatenate(out, axis=1)

    def _recover(self, seq_id: int, template):
        restored = self.pages.restore_cache(seq_id, template)
        if restored is None:
            raise RuntimeError("no snapshot to recover from")
        return restored


# --------------------------------------------------------- serving at load
#: captured page-fetch trace tables, keyed by geometry and the capture's
#: device (capture is ~100 ms; a load sweep calls serve_kv_at_load once per
#: point)
_page_traces: Dict[Tuple, dict] = {}


def serve_kv_at_load(offered_kops: float, *, n_clients: int = 4,
                     n_shards: int = 2, vsize: int = 1024,
                     read_frac: float = 0.9, coalesce: bool = True,
                     share_qp: bool = False, slo_us: Optional[float] = None,
                     admission: str = "queue", horizon_s: float = 0.02,
                     seed: int = 0, p=None, replication: int = 1,
                     capture_batches: Optional[Tuple[int, ...]] = None,
                     device="cuda", **cfg_kwargs) -> dict:
    """Serve Erda-backed KV page fetches at a fixed OFFERED load (KOp/s).

    Captures doorbell traces of real ``ErdaCluster`` ``multi_read`` /
    ``multi_write`` page ops (once per geometry and device), then replays
    Poisson arrivals through the contended fabric with bounded admission
    queues and (optionally) adaptive doorbell coalescing.  Returns the
    ``run_open_loop`` report: throughput, p50/p95/p99 per op type, drops,
    per-QP HoL stats, port utilization, persistence lag.

    ``share_qp=True`` merges doorbells ACROSS the client streams sharing
    each (host, shard) QP instead of per client; ``slo_us`` gives every
    request a deadline and turns on goodput accounting, and
    ``admission="slo"`` sheds by earliest infeasible deadline instead of
    queue position (see ``repro_torch.serving.load``).

    ``replication>1`` serves off a quorum-mirrored page store: every write's
    mirror legs ride extra lanes pinned to the host ports that hold the
    backup replicas, so replicated write amplification shows up in NIC
    utilization and write tail latency — and under ``share_qp=True`` the
    mirror lanes coalesce on the same shared QPs as the primary traffic.

    ``device`` is where the capture's clients CRC-verify the pages they
    fetch; a capture made on one device never serves a call for another.
    """
    import dataclasses
    from repro_torch.netsim.pricing import SimParams
    from repro_torch.serving.load import (OpenLoopConfig,
                                          capture_page_fetch_traces,
                                          run_open_loop)
    p = p or SimParams()
    device = resolve_device(device)
    key = (n_shards, vsize, replication, capture_batches, str(device)) \
        + dataclasses.astuple(p)
    traces = _page_traces.get(key)
    if traces is None:
        kwargs = {} if capture_batches is None \
            else {"batches": capture_batches}
        traces = _page_traces[key] = capture_page_fetch_traces(
            n_shards=n_shards, vsize=vsize, p=p, replication=replication,
            device=device, **kwargs)
    cfg = OpenLoopConfig(offered_kops=offered_kops, n_clients=n_clients,
                         horizon_s=horizon_s, coalesce=coalesce,
                         share_qp=share_qp,
                         slo_s=None if slo_us is None else slo_us * 1e-6,
                         admission=admission,
                         read_frac=read_frac, seed=seed, **cfg_kwargs)
    return run_open_loop(traces, cfg, p)
