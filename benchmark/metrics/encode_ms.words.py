"""Host-clock time of a batch's log-mel and encoder, in the cells that
report ``audio_s_per_s.words``."""

from benchmark.metrics._eval import encode_ms

LAYER = "model (models.whisper, ops.log_mel_spectrogram)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.words"
BETTER = "lower"


def read(facts):
    return encode_ms(facts)
