"""What a run hands the per-layer readers (``erdabench/metrics/*.py``): host
spans, the traced slice's profile, and the program's counters."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from erdabench.trace import Profile


@dataclasses.dataclass
class Reading:
    model: Dict                       # the configuration's ``model`` dict
    mix: Dict                         # the traffic mix
    #: (name, start_s, end_s, bytes) of each wrapped call outside the traced
    #: slice: prefill, decode_step, snapshot_cache, restore_cache, put_page,
    #: get_page, train_step
    calls: List[Tuple[str, float, float, int]] = dataclasses.field(default_factory=list)
    #: (name, start_s, end_s) host segments outside the traced slice: each
    #: runs from a wrapped call's start to the next one's (or to the end of
    #: its request batch), named prefill, decode, snapshot, restore, step
    segments: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    #: the same inside the traced slice
    traced_segments: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    profile: Optional[Profile] = None
    #: program counters: flash and CRC launch shapes in the traced slice
    #: (``flash_shapes``, ``crc_shapes``), NVM bytes written and page bytes
    #: handed to the store outside it (``nvm_bytes``, ``page_bytes``)
    counters: Dict = dataclasses.field(default_factory=dict)

    def seconds(self, name: str, traced: bool = False) -> float:
        segs = self.traced_segments if traced else self.segments
        return sum(b - a for n, a, b in segs if n == name)

    def count(self, name: str, traced: bool = False) -> int:
        segs = self.traced_segments if traced else self.segments
        return sum(n == name for n, _a, _b in segs)

    def idle_percent(self, name: str) -> Optional[float]:
        """Per cent of the traced slice's ``name`` segments in which the
        device ran nothing; None without a trace or such segments."""
        spans = [(a, b) for n, a, b in self.traced_segments if n == name]
        host = sum(b - a for a, b in spans)
        if self.profile is None or not host:
            return None
        return 100.0 * (1.0 - self.profile.busy_s(spans) / host)
