"""Host utilities: step timers and parameter-tree inspection (copies of
``whisper_ipa_tpu.utils``' ``timing`` and ``trees``)."""

from .timing import StepTimer, Throughput
from .trees import tree_bytes, tree_count, tree_summary

__all__ = [
    "StepTimer",
    "Throughput",
    "tree_bytes",
    "tree_count",
    "tree_summary",
]
