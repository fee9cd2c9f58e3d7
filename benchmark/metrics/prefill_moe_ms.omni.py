"""Stream time of one layer's MoE in the prefill (the span
``llm.prefill.moe``: the routing, the tokens grouped by expert with one
host read of the group sizes, each routed expert over its own rows, the
shared experts), averaged over the layers and calls of the profiled
stretch, in Uni-MoE-2.0-Omni's cell ``omni.eval-long``."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "audio language model (models.audio_llm)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    if facts.get("kind") != "audio_llm_batch":
        return None
    return mean_stream_ms(facts, "llm.prefill.moe")
