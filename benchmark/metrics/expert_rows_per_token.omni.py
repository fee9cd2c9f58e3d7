"""Expert-GEMM rows computed a token in each MoE layer, from the program's
routing counter, over the prefill (grouped: the non-null picks) and the
decode steps (static: every routed expert), in
Uni-MoE-2.0-Omni's cell ``omni.eval-long``. Its floor is the
routing's own non-null picks a token."""

from benchmark.metrics._omni import expert_rows_per_token

LAYER = "audio language model (models.audio_llm)"
UNIT = "rows/token"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.large"
BETTER = "lower"


def read(facts):
    return expert_rows_per_token(facts)
