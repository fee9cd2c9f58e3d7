"""The reader of the decode loop's CUDA-graph share, shared by its metric
files (``graph_step_pct.*``).

The program's greedy loop captures one iteration as a CUDA graph and
replays it in every step but the first and the last, each replay inside
its step as the span ``decode.replay``. A program that never replays (one
without the graph path, such as a commit before it) leaves nothing to
read: the reader returns None.
"""

from __future__ import annotations

from typing import Optional

from benchmark.metrics._program import stretch_spans


def graph_step_pct(facts) -> Optional[float]:
    """The share of the profiled stretch's ``decode.step`` spans that
    replayed the graph: ``decode.replay`` spans over ``decode.step``
    spans, in %."""
    replays = len(stretch_spans(facts, "decode.replay"))
    steps = len(stretch_spans(facts, "decode.step"))
    if not replays or not steps:
        return None
    return 100.0 * replays / steps
