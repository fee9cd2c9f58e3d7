"""Stream time of the audio connector (the span ``llm.connector``: the
tower's 1500 frames pooled to 200 and projected to the language model's
width), averaged over the calls of the profiled stretch, in
Uni-MoE-2.0-Omni's cell ``omni.eval-long``."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "audio language model (models.audio_llm)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    if facts.get("kind") != "audio_llm_batch":
        return None
    return mean_stream_ms(facts, "llm.connector")
