"""Stream time of the K/V cache's build in a ``decode`` call (the span
``llm.init_cache``: every layer's K/V, the RoPE tables, the routes),
averaged over the calls of the profiled stretch, in Uni-MoE-2.0-Omni's
cell ``omni.eval-long``."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "decode loop (decode.decoding)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    if facts.get("kind") != "audio_llm_batch":
        return None
    return mean_stream_ms(facts, "llm.init_cache")
