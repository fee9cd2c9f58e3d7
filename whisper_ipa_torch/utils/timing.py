"""Timing helpers: step timers, throughput meters and the program's spans.

The PyTorch package's copy of ``whisper_ipa_tpu/utils/timing.py``. Device
work is waited for before a timer stops (``stop(sync=...)`` synchronizes
the CUDA devices that hold the given tensors), so timings reflect real
completion, not asynchronous launches.

Spans (the port's own; the reference has none): ``span(name)`` marks a
stretch of the program, such as one ``decode`` call, its cache build or
one step of its loop. It records only while a ``torch.profiler`` is
recording or inside ``tracing()``; otherwise entering it is a flag test
and nothing more: no CUDA call, no allocation, no synchronisation.
While the current stream captures a CUDA graph a span records nothing
either: its CUDA events would become nodes of the graph. A
record (``SpanRecord``) holds the span's name, its id, its parent's id,
the id of the outermost span it runs in (``call``: one ``decode`` call,
one training step), its host interval and, where CUDA is initialised,
its interval on the current stream, from two timing events that
``records()`` resolves when the records are read. Records stay in
memory until recording next turns on: reading them clears nothing.
Recording turns on at ``tracing()``'s entry, or at the first span that
finds a profiler recording after one that found none; two profiler runs
with no span between them share one recording, and the markers in each
run's trace tell its records apart.

Under the profiler a span also leaves two markers in the trace, empty
``record_function`` ranges named by ``marker`` at its start and at its
end. They put the span on the profiler's clock (``prof.events()``,
``export_chrome_trace``), paired with its record by id. A range that
encloses no launch gets no mirror on the device's timeline, so the
markers leave the trace's device operations as they are; a range around
the span itself would be mirrored over its kernels and their gaps.

A program's counters (such as ``models.audio_llm``'s routing counter) ask
``recording()`` whether to count: when spans would record, a CUDA graph's
capture included, and never inside ``paused()``. ``current()`` names the
open span a counter's reading belongs to.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

from .trees import tree_leaves


def synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``."""
    devices = {x.device for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class StepTimer:
    """Accumulates wall-clock samples with mean/percentile summaries."""

    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, sync=None) -> float:
        if sync is not None:
            synchronize(sync)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def mean(self) -> float:
        return sum(self.samples) / max(len(self.samples), 1)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(int(q / 100.0 * len(s)), len(s) - 1)
        return s[idx]


class Throughput:
    """items/sec over a rolling window."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: List[tuple] = []

    def update(self, n_items: int):
        self._events.append((time.perf_counter(), n_items))
        self._events = self._events[-self.window :]

    @property
    def rate(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        items = sum(n for _, n in self._events[1:])
        return items / dt if dt > 0 else 0.0


# -- spans ----------------------------------------------------------------

_MARK = "span:"  # the markers' names: _MARK + name + "#" + id + "[" or "]"


def marker(name: str, rid: int, end: bool) -> str:
    """The name of span ``rid``'s marker at its start or its ``end``."""
    return f"{_MARK}{name}#{rid}{']' if end else '['}"


def parse_marker(text: str) -> Optional[Tuple[str, int, bool]]:
    """(name, id, end) of a marker's name; None for any other name."""
    if not text.startswith(_MARK) or text[-1:] not in ("[", "]"):
        return None
    name, _, rid = text[len(_MARK):-1].rpartition("#")
    if not name or not rid.isdigit():
        return None
    return name, int(rid), text[-1] == "]"


@dataclass
class SpanRecord:
    """One span. Host times are ``time.perf_counter()`` seconds; stream
    times are milliseconds on the current stream from the first event
    recorded on its device since recording turned on (None without
    CUDA, and until ``records()`` resolves them)."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    host_start: float
    host_end: Optional[float] = None
    stream_start_ms: Optional[float] = None
    stream_end_ms: Optional[float] = None
    _events: Optional[tuple] = field(default=None, repr=False, compare=False)

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.host_end - self.host_start)

    @property
    def stream_ms(self) -> Optional[float]:
        if self.stream_start_ms is None:
            return None
        return self.stream_end_ms - self.stream_start_ms


class _Recorder:
    """The process's span records (one recorder: spans sit deep inside
    library calls, which take no recorder argument)."""

    def __init__(self):
        self.depth = 0  # open tracing() blocks
        self.paused = 0  # open paused() blocks
        self.off_seen = True  # a span found recording off since the last record
        self.records: List[SpanRecord] = []
        self.epochs = {}  # device index -> the origin of its stream times
        self.ids = itertools.count(1)
        self.local = threading.local()  # each thread's open spans

    def clear(self) -> None:
        self.records, self.epochs = [], {}

    def stack(self) -> List[SpanRecord]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


_NO_SPAN = contextlib.nullcontext()


def _mark(name: str, rid: int, end: bool) -> None:
    if _profiler._is_profiler_enabled:
        with torch.profiler.record_function(marker(name, rid, end)):
            pass


def _stream_event(dev: int) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


class _Span:
    __slots__ = ("name", "rec", "dev")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        r = _REC
        if r.off_seen:  # a profiler started since the last span
            r.clear()
            r.off_seen = False
        stack = r.stack()
        parent = stack[-1] if stack else None
        rid = next(r.ids)
        _mark(self.name, rid, False)
        rec = SpanRecord(self.name, rid, parent.id if parent else None,
                         parent.call if parent else rid, time.perf_counter())
        if torch.cuda.is_initialized():
            self.dev = dev = torch.cuda.current_device()
            if dev not in r.epochs:
                r.epochs[dev] = _stream_event(dev)
            rec._events = (r.epochs[dev], _stream_event(dev))
        stack.append(rec)
        r.records.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec._events is not None:
            rec._events += (_stream_event(self.dev),)
        rec.host_end = time.perf_counter()
        _mark(self.name, rec.id, True)
        _REC.stack().pop()
        return False


def _capturing() -> bool:
    """A CUDA graph is being captured on the current stream (no capture
    can be underway where CUDA was never initialised)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def span(name: str):
    """A context manager that records the stretch it encloses as the span
    ``name`` while recording is on and the current stream is not
    capturing a CUDA graph (see the module docstring)."""
    if _REC.depth or _profiler._is_profiler_enabled:
        return _NO_SPAN if _capturing() else _Span(name)
    _REC.off_seen = True
    return _NO_SPAN


def recording() -> bool:
    """Whether the program's counters record now: inside ``tracing()`` or
    under a profiler, as spans, but also while a CUDA graph is captured
    (a counter's device additions become nodes of the graph, and each
    replay counts again), and not inside ``paused()``."""
    return bool((_REC.depth or _profiler._is_profiler_enabled) and not _REC.paused)


@contextlib.contextmanager
def paused():
    """Counters record nothing inside this block (spans are unaffected):
    for work the program runs twice, such as a capture's warm-up."""
    _REC.paused += 1
    try:
        yield
    finally:
        _REC.paused -= 1


def current() -> Optional[SpanRecord]:
    """The innermost span this thread has open and recording, or None."""
    stack = _REC.stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def tracing():
    """Record spans inside this block, with or without a profiler; the
    records of an earlier recording are cleared on entry."""
    if not _REC.depth:
        _REC.clear()
        _REC.off_seen = False
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1
        if not _REC.depth:
            _REC.off_seen = True


def records() -> List[SpanRecord]:
    """The closed spans of the latest recording, in the order they
    started, their stream times resolved (a wait for the device where
    some are still pending). Reading clears nothing."""
    done = [r for r in list(_REC.records) if r.host_end is not None]
    for r in done:
        if r._events is not None:
            epoch, start, end = r._events
            end.synchronize()
            r.stream_start_ms = epoch.elapsed_time(start)
            r.stream_end_ms = epoch.elapsed_time(end)
            r._events = None
    return done
