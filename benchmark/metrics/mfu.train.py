"""The whole step's share of the card's bf16 peak: ``train_step_flops``
(the frozen encoder's forward, the decoder's forward and backward) of
every sample over its real, unpadded decoder positions, over the
host-clock time of the chunks outside the profiled stretch."""

from benchmark.metrics._common import mfu_pct
from benchmark.roofline import flops

LAYER = "whole program"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_samples_per_s"
BETTER = "higher"


def read(facts):
    if "n_inputs" not in facts:
        return None
    d = facts["dims"]
    chunk = sum(flops.train_step_flops(d["n_mels"], d["d_model"], d["decoder_layers"],
                                       d["n_vocab"], n, d["n_audio_ctx"])
                for n in facts["n_inputs"])
    return mfu_pct(facts, chunk)
