"""Stream time of the cross cache's build in a ``decode`` call (the span
``decode.init_cache``: every decoder layer's K/V projection of the audio
features and their int8 quantization), averaged over the calls of the
profiled stretch, in the cell that reports ``audio_s_per_s.words``."""

from benchmark.metrics._program import mean_stream_ms

LAYER = "decode loop (decode.decoding)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.words"
BETTER = "lower"


def read(facts):
    return mean_stream_ms(facts, "decode.init_cache")
