"""Host utilities: step timers and parameter-tree inspection; the submodules
``flops`` (the analytic FLOP model, with the port's peak table) and
``xlsx`` (a minimal XLSX reader/writer). Copies of ``whisper_ipa_tpu.utils``'
modules of the same names, exported as that package exports them."""

from .timing import StepTimer, Throughput
from .trees import tree_bytes, tree_count, tree_summary

__all__ = [
    "StepTimer",
    "Throughput",
    "tree_bytes",
    "tree_count",
    "tree_summary",
]
