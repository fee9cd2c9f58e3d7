"""The readers of the program's own spans (``whisper_ipa_torch.utils.timing``),
shared by their metric files.

A span's record (``timing.records()``) gives its host and stream times;
its two markers in the profiled stretch (``facts["stretch"].host``) put it
on the profiler's clock, beside the device's operations. A reader takes
only the spans with a record and both markers in the stretch, so a record
made outside the stretch is never read. A program without spans, such as
a commit before them, leaves nothing to read: every reader returns None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.metrics._common import stretch


def _timing():
    try:
        from whisper_ipa_torch.utils import timing
    except ImportError:
        return None
    if not (hasattr(timing, "records") and hasattr(timing, "parse_marker")):
        return None
    return timing


def stretch_spans(facts, name: str) -> List[Tuple[object, float, float]]:
    """(record, start, end) of each span ``name`` that the program recorded
    and whose start and end markers are both in the profiled stretch, in
    microseconds on the profiler's clock, from the start marker's start
    to the end marker's end."""
    st, timing = stretch(facts), _timing()
    if st is None or timing is None:
        return []
    recs = {r.id: r for r in timing.records() if r.name == name}
    starts, ends = {}, {}
    for text, s, e in st.host:
        m = timing.parse_marker(text)
        if m is not None and m[0] == name and m[1] in recs:
            (ends if m[2] else starts)[m[1]] = (s, e)
    return [(recs[rid], s, ends[rid][1]) for rid, (s, _) in starts.items()
            if rid in ends]


def _mean(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def mean_stream_ms(facts, name: str) -> Optional[float]:
    """Mean time of the span ``name`` on the card's stream: from the event
    recorded at its start to the one at its end, the waits inside it
    included."""
    return _mean(r.stream_ms for r, _, _ in stretch_spans(facts, name))


def mean_host_ms(facts, name: str) -> Optional[float]:
    """Mean time the host spent inside the span ``name``."""
    return _mean(r.host_ms for r, _, _ in stretch_spans(facts, name))


def idle_inside_pct(facts, name: str) -> Optional[float]:
    """The share of the stretch's device idle time (``Stretch.gaps``) that
    falls while the host is inside a span ``name``, on the profiler's
    clock; 0 where the device never idles."""
    ranges = sorted((s, e) for _, s, e in stretch_spans(facts, name))
    if not ranges:
        return None
    gaps = stretch(facts).gaps()
    total = sum(e - s for s, e in gaps)
    if total <= 0:
        return 0.0
    inside, i = 0.0, 0
    for gs, ge in gaps:  # both sorted; the spans of one name do not overlap
        while i < len(ranges) and ranges[i][1] <= gs:
            i += 1
        j = i
        while j < len(ranges) and ranges[j][0] < ge:
            inside += max(0.0, min(ge, ranges[j][1]) - max(gs, ranges[j][0]))
            j += 1
    return 100.0 * inside / total
