"""Spans and counters of the port's own layers, on ``time.perf_counter``.

    from repro_torch import tracing
    tracing.enable()
    with tracing.span("pages.snapshot", leaves=4) as s:
        ...
        s.add(bytes=n)
    tracing.count("moe.dropped", dropped)      # an int or a device tensor
    spans, counters = tracing.take()

A span records its name, an id, its parent's id (the span open around it
when it opened), its root's id (the outermost span open then), the request
it belongs to, its start and end, and the integer counts given where it
opened or added before it closed.  The request is the one the outermost
span names with ``request=``: ``ServeEngine.generate`` names its
``seq_id``, a train step its step number.  Spans stay in memory until
``take()``, which returns them in order of start together with the
counters, and clears both.

While a ``torch.profiler`` session is open, each span also opens a
``record_function`` of its name, so the span exists on the profiler's clock
as well, beside the device operations launched inside it.

Counters hold only what no other family of the port counts: ``NVMStats``,
the Erda client's ``stats`` and ``kernels.build.LaunchCount`` keep their
own.  A counter's value may be a device tensor; it is summed on its device
without a host sync and read to the host once, in ``take()``.  Each value
is kept in the counts of the innermost span open when it was counted, so a
reader can tell a prefill's counts from a decode step's; ``take()`` also
sums each counter over all of them.

When the recorder is off, ``span()`` returns one shared null context and
``count()`` returns at once: nothing is recorded, no tensor is made, no
device operation is launched and the host does not wait for the device.
A caller whose counter value itself costs a launch asks ``enabled()``
first.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(slots=True)
class SpanRecord:
    name: str
    id: int
    parent: Optional[int]      # None for an outermost span
    root: int                  # the outermost span's id (its own for one)
    request: Optional[int]     # the request the outermost span named
    t0: float                  # perf_counter seconds
    t1: float
    counts: Dict[str, int]
    #: the second just before its profiler twin opened (None: no twin); the
    #: twin's own start lies between this and ``t0``
    t_twin: Optional[float] = None


class _NullSpan:
    """What ``span()`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **counts) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("rec", "name", "request", "counts", "id", "parent", "root",
                 "t0", "twin", "t_twin")

    def __init__(self, rec: "Recorder", name: str, request: Optional[int],
                 counts: Dict[str, int]):
        self.rec, self.name, self.request, self.counts = rec, name, request, counts

    def add(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)

    def __enter__(self) -> "_Span":
        rec = self.rec
        self.id = next(rec.ids)
        outer = rec.stack[-1] if rec.stack else None
        if outer is None:
            self.parent, self.root = None, self.id
        else:
            self.parent, self.root = outer.id, outer.root
            self.request = outer.request
        rec.stack.append(self)
        self.twin = self.t_twin = None
        if torch._C._autograd._profiler_enabled():
            self.t_twin = time.perf_counter()
            self.twin = torch.profiler.record_function(self.name)
            self.twin.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self.twin is not None:
            self.twin.__exit__(None, None, None)
        rec = self.rec
        rec.stack.pop()
        rec.spans.append(SpanRecord(self.name, self.id, self.parent, self.root,
                                    self.request, self.t0, t1, self.counts, self.t_twin))
        return False


class Recorder:
    """Spans and counters of one process's layers; the module's functions
    drive one shared instance."""

    def __init__(self):
        self.on = False
        self.ids = itertools.count()
        self.stack: List[_Span] = []
        self.spans: List[SpanRecord] = []
        self.loose: Dict[str, object] = {}   # counted with no span open
        self.counted: set = set()            # counters' names since take()

    def span(self, name: str, request: Optional[int], counts: Dict) -> _Span:
        return _Span(self, name, request, {k: int(v) for k, v in counts.items()})

    def count(self, name: str, value) -> None:
        into = self.stack[-1].counts if self.stack else self.loose
        prev = into.get(name)
        into[name] = value if prev is None else prev + value
        self.counted.add(name)

    def take(self) -> Tuple[List[SpanRecord], Dict[str, int]]:
        spans = sorted(self.spans, key=lambda s: (s.t0, s.id))
        counters = {k: 0 for k in self.counted}
        for counts in [s.counts for s in spans] + [self.loose]:
            for k, v in counts.items():
                counts[k] = int(v)
                if k in counters:
                    counters[k] += counts[k]
        self.spans, self.loose, self.counted = [], {}, set()
        return spans, counters


_RECORDER = Recorder()


def enable() -> None:
    """Start recording spans and counters."""
    _RECORDER.on = True


def disable() -> None:
    """Stop recording; what was recorded waits for ``take()``."""
    _RECORDER.on = False


def enabled() -> bool:
    return _RECORDER.on


def span(name: str, request: Optional[int] = None, **counts):
    """A context manager timing the code inside it as span ``name``, with
    integer ``counts`` (bytes, rows, tokens); its ``add(**counts)`` adds
    more before it closes.  ``request`` names the request an outermost span
    serves."""
    if not _RECORDER.on:
        return NULL_SPAN
    return _RECORDER.span(name, request, counts)


def count(name: str, value) -> None:
    """Add ``value`` (an int or a tensor, summed where it lives) to counter
    ``name``."""
    if _RECORDER.on:
        _RECORDER.count(name, value)


def take() -> Tuple[List[SpanRecord], Dict[str, int]]:
    """The spans closed and the counters summed since the last ``take()``,
    the spans in order of start; clears both.  Reads device counters to
    the host."""
    return _RECORDER.take()
