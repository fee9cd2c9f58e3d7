"""Cells cut to a size the CPU runs in seconds: the published cell's
traffic kind and layout, with a 64-wide, two-layer model (the full
vocabulary, so the special tokens stay where they are), four rows a
batch and a few tokens. Limits set from readings of this size (the
program's in bfloat16 on the CPU, the controls', the faults'):

  max_gap   program 0-5.8e-4 on seeds 1-3, float8 control 0.0255-0.0326,
            second-best tokens 0.069-0.086 -> 1e-3
  logprob_gap program 3.4-7.0e-4, float8 control 0.0052-0.0103 -> 1.1e-3
  loss_gap  program 0.9-5.2e-5, control 2.4-6.3e-4, half batch 1.7-3.1e-3 -> 1e-4
  grad_gap  program 0.0068-0.0084, control 0.054-0.063, half batch 0.34-0.80,
            state unchanged 1.0 -> 0.015
  update_gap program 0.0035-0.0126, control 0.020-0.027, half batch
            0.098-0.191, state unchanged 1.0 -> 0.05
"""

import torch

from benchmark.harness import cli, registry

TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
            decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256)
LIMITS = {"eval_batch": {"max_gap": 1e-3, "logprob_gap": 1.1e-3},
          "finetune": {"loss_gap": 1e-4, "grad_gap": 0.015, "update_gap": 0.05}}


def cell(name: str) -> dict:
    c = registry.cell(name)
    c["config_file"] = dict(c["config_file"], **TINY)
    if c["mix"]["kind"] == "eval_batch":
        c["mix"] = dict(c["mix"], batch=4, sample_len=6, distinct_batches=2, check_rows=3)
    else:
        c["mix"] = dict(c["mix"], batch=4, target_tokens=[3, 12], distinct_batches=3)
    c["limits"] = LIMITS[c["mix"]["kind"]]
    return c


def driver(name: str, seed: int):
    return cli.make_driver(cell(name), seed, torch.device("cpu"), "cpu")
