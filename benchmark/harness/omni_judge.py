"""The comparison that decides ``correct`` in the audio language model's
cell, against the plain reference (``reference/uni_moe_omni.py``).

The reference runs once over each sampled row: its log-mel, its prompt
and its served tokens teacher-forced, in float32, with the weights drawn
again part by part (``omni_weights.draw_part``), one layer held at a
time. Each served token is judged by how far its logit lies below the
reference's best allowed logit at its position (``max_gap``, the widest
over the sample; the allowed ids are those below the first special one),
each row by how far the program's ``avg_logprob`` lies from the
reference's for the same tokens (``logprob_gap``). The reference routes
by its own gate except within ``EPS`` of a boundary, where it takes the
program's recorded choice; ``forced_routes`` counts the choices it took
that differ from its own.

``EPS``, 0.02 in probability: the program computes the gate's input in
bfloat16 after 2 x 28 residual sublayers in bfloat16, about 1% from the
reference's float32 input; through a gate whose logits are about N(0, 1)
that moves a logit by about 0.01-0.02, and a probability by at most a
quarter of the two logits' moves together, under 0.01. Twice that is
where a bfloat16 program can flip a choice that the reference makes by
a margin; the float8 control (3 mantissa bits against bfloat16's 7)
flips beyond it.

The control: the float8 reference in the program's place, teacher-forced
on the same tokens, routing by its own gate; the float32 reference then
follows its routes under the same rule. It reads the gap of the token the
control puts first, its ``avg_logprob`` of the served tokens against the
float32 one's, and the routes forced.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Sequence

import torch

from benchmark.harness import omni_weights
from benchmark.reference import mel as ref_mel
from benchmark.reference import uni_moe_omni as ref
from benchmark.reference.precision import FP8, FP32

EPS = 0.02


def sizes(c: Dict) -> SimpleNamespace:
    """The reference's sizes from the configuration file's keys."""
    return SimpleNamespace(
        n_layer=c["num_hidden_layers"], n_head=c["num_attention_heads"],
        n_kv_head=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        rope_theta=float(c["rope_theta"]), rms_eps=c["rms_norm_eps"],
        n_shared=c["mlp_fixed_expert_num"], n_routed=c["mlp_dynamic_expert_num"],
        top_p=c["mlp_dynamic_top_p"], top_k=c["mlp_dynamic_top_k"],
        n_audio_tokens=c["whisper_query_tokens_size"],
        tower_heads=c["encoder_attention_heads"])


def served_gaps(c: Dict, dims: Dict[str, int], seed: int, waves: torch.Tensor,
                prompt: Sequence[int], audio_start: int, served: Sequence[Sequence[int]],
                avg_logprobs: Sequence[float], routes: List[torch.Tensor],
                first_special: int, control: bool = False) -> Dict[str, float]:
    """{"max_gap", "logprob_gap", "forced_routes"} of the program's rows
    (``routes``: each row's (L, T, top_k) slots)[, and the float8
    control's as "control_max_gap", "control_logprob_gap",
    "control_forced_routes"]."""
    dev = waves.device
    s = sizes(c)
    P = len(prompt)

    def get(name):
        return omni_weights.draw_part(c, dims, seed, dev, name, as_float=True)

    mel = ref_mel.log_mel(waves, dims["n_mels"])
    prompt_ids = torch.tensor([list(prompt)] * len(served), device=dev)
    toks = torch.tensor([list(r[:-1]) for r in served], dtype=torch.long, device=dev)
    served_t = torch.tensor([list(r) for r in served], dtype=torch.long, device=dev)
    T = P + toks.shape[1]
    taken = torch.stack([r[:, :T] for r in routes], 1).to(dev)  # (L, B, T, K)

    def run(prec, follow, eps):
        lg, forced, slots = ref.logits(get, s, mel, prompt_ids, audio_start, toks, prec,
                                       follow, eps, keep_from=P - 1)
        return lg[..., :first_special], forced, slots

    def avg_logprob(lg, chosen):
        lp = torch.log_softmax(lg, dim=-1).gather(-1, chosen[..., None])[..., 0]
        return lp.sum(-1) / (chosen.shape[1] + 1)  # the tokens and the end decision

    def gaps(lg, chosen):
        best = lg.amax(-1)
        allowed = chosen < first_special
        inside = chosen.clamp(0, first_special - 1)
        got = lg.gather(-1, inside[..., None])[..., 0]
        return torch.where(allowed, best - got, torch.full_like(got, float("inf"))), \
            allowed.all(-1), inside

    lg, forced, _ = run(FP32, taken, EPS)
    gap, rows_ok, inside = gaps(lg, served_t)
    want_lp = avg_logprob(lg, inside)
    prog_lp = torch.tensor(list(avg_logprobs), dtype=torch.float32, device=dev)
    lp_gap = torch.where(rows_ok, (prog_lp - want_lp).abs(),
                         torch.full_like(want_lp, float("inf")))
    out = {"max_gap": float(gap.max()), "logprob_gap": float(lp_gap.max()),
           "forced_routes": float(forced)}
    del lg
    if control:
        lg8, _, slots8 = run(FP8, None, 0.0)
        choice = lg8.argmax(-1)
        lg32, forced_c, _ = run(FP32, slots8, EPS)
        best = lg32.amax(-1)
        out["control_max_gap"] = float((best - lg32.gather(-1, choice[..., None])[..., 0]).max())
        out["control_logprob_gap"] = float(
            (avg_logprob(lg8, inside) - avg_logprob(lg32, inside)).abs().max())
        out["control_forced_routes"] = float(forced_c)
    return out
