"""Host-clock time of one forward of the language model in a ``decode``
call (the connector and the prefill count as the first, then
``new_tokens`` - 1 single-token steps), in Uni-MoE-2.0-Omni's cell
``omni.eval-long``."""

from benchmark.metrics._omni import decode_step_ms

LAYER = "decode loop (decode.decoding)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    return decode_step_ms(facts)
