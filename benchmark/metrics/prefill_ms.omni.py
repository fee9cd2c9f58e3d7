"""Stream time of the audio language model's prefill (the span
``llm.prefill``: the prompt's embeddings with the connector's audio
tokens, every layer with its grouped MoE, the head on the last position),
averaged over the calls of the profiled stretch, in
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
    return mean_stream_ms(facts, "llm.prefill")
