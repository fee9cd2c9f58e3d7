"""The comparisons that decide ``correct``, against the plain reference.

Served tokens: the reference runs once over each sampled prompt with its
served tokens (teacher-forced), with the cross cache the configuration
states (int8: the reference rounds its own float32 keys and values). Each served token is judged by how far its
logit lies below the reference's best allowed logit at its position
(``max_gap``, the widest over the sample), and each row by how far the
program's ``avg_logprob`` lies from the reference's for the same tokens
(``logprob_gap``, the widest over the sample). A token outside the allowed
set reads infinite. The float8 reference in the program's place reads, at
the same positions, the gap of the token it puts first and its own
``avg_logprob`` of the served tokens.

Training: the reference follows the program's checked steps (one alone,
then one chunk of the window's length) from the same weights and
batches. The readings are the worst step's relative loss gap, and over
the trainable leaves the worst gap between the program's and the
reference's norms of the first clipped gradient and of the parameters'
change after the last checked step, each against the reference's norm of
that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.harness import weights
from benchmark.reference import mel as ref_mel
from benchmark.reference import whisper as ref
from benchmark.reference.adamw import AdamW
from benchmark.reference.precision import FP8, FP32, Precision
from benchmark.reference.tokens import special_ids


def served_gaps(params, dims: Dict[str, int], waves: torch.Tensor,
                served: Sequence[Sequence[int]], avg_logprobs: Sequence[float],
                prefix: List[int], eot: int, cross_int8: bool,
                control: bool = False) -> Dict[str, float]:
    """{"max_gap", "logprob_gap"} of the program's rows[, and the float8
    reference's as "control_max_gap", "control_logprob_gap"]."""
    ref.full_fp32()
    P = len(prefix)
    dev = waves.device
    with torch.no_grad():
        mel = ref_mel.log_mel(waves, dims["n_mels"])
        toks = torch.tensor([list(prefix) + list(s[:-1]) for s in served],
                            dtype=torch.long, device=dev)
        served_t = torch.tensor([list(s) for s in served], dtype=torch.long, device=dev)

        def logits(prec):
            feats = ref.encode_blocks(params, dims["encoder_heads"], mel, prec=prec)
            return ref.decoder_logits(params, dims["decoder_heads"], toks, feats,
                                      prec=prec, cross_int8=cross_int8)[:, P - 1:, :eot]

        def avg_logprob(lg, chosen):
            lp = torch.log_softmax(lg, dim=-1).gather(-1, chosen[..., None])[..., 0]
            # Whisper's convention: over the tokens and the EOT decision
            return lp.sum(-1) / (chosen.shape[1] + 1)

        lg = logits(FP32)
        best = lg.amax(-1)
        allowed = served_t < eot
        inside = served_t.clamp(0, eot - 1)
        got = lg.gather(-1, inside[..., None])[..., 0]
        gap = torch.where(allowed, best - got, torch.full_like(got, float("inf")))
        want_lp = avg_logprob(lg, inside)
        prog_lp = torch.tensor(list(avg_logprobs), dtype=torch.float32, device=dev)
        lp_gap = torch.where(allowed.all(-1), (prog_lp - want_lp).abs(),
                             torch.full_like(want_lp, float("inf")))
        out = {"max_gap": float(gap.max()), "logprob_gap": float(lp_gap.max())}
        if control:
            lg_c = logits(FP8)
            choice = lg_c.argmax(-1)
            out["control_max_gap"] = float((best - lg.gather(-1, choice[..., None])[..., 0]).max())
            out["control_logprob_gap"] = float((avg_logprob(lg_c, inside) - want_lp).abs().max())
    return out


def reference_steps(dims: Dict[str, int], seed: int, device, waves: List[torch.Tensor],
                    tokens: List[torch.Tensor], lr: float, max_norm: float,
                    weight_decay: float, prec: Precision = FP32):
    """The reference's steps, one a batch, from the harness's weights: (losses,
    {leaf: clipped first gradient}, {leaf: change after the steps},
    {leaf: norm of the raw first gradient}). Only decoder leaves train."""
    ref.full_fp32()
    params = weights.make_params(dims, seed, device)
    flat = dict(weights.leaves(params))
    names = [n for n in flat if n.startswith("decoder.")]
    start = {n: flat[n].clone() for n in names}
    opt = AdamW(lr, max_norm, weight_decay)
    eot = special_ids(dims["n_vocab"])["eot"]
    losses, g1, raw1 = [], {}, {}
    for step, (w, t) in enumerate(zip(waves, tokens)):
        feats = ref.encode_blocks(params, dims["encoder_heads"],
                                  ref_mel.log_mel(w, dims["n_mels"]), prec=prec)
        leaves = [flat[n] for n in names]
        for x in leaves:
            x.requires_grad_(True)
        loss = ref.loss(params, dims["decoder_heads"], t, feats, eot, prec)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for x in leaves:
            x.requires_grad_(False)
        grads = {n: torch.zeros_like(flat[n]) if g is None else g
                 for n, g in zip(names, grads)}
        clipped = opt.step({n: flat[n] for n in names}, grads)
        if step == 0:
            g1 = {n: torch.linalg.vector_norm(g).item() for n, g in clipped.items()}
            raw1 = {n: torch.linalg.vector_norm(g).item() for n, g in grads.items()}
        losses.append(loss.item())
        del feats, loss, grads, clipped
    change = {n: torch.linalg.vector_norm(flat[n] - start[n]).item() for n in names}
    return losses, g1, change, raw1


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def training_readings(prog_losses: Sequence[float], prog_g1: Dict[str, float],
                      prog_change: Dict[str, float], ref_losses: Sequence[float],
                      ref_g1: Dict[str, float], ref_change: Dict[str, float],
                      ref_raw1: Dict[str, float]) -> Dict[str, float]:
    """{"loss_gap", "grad_gap", "update_gap"} and the leaves left out."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref_losses))
    med_raw = _median(list(ref_raw1.values()))
    kept = [n for n in ref_raw1 if ref_raw1[n] >= 1e-3 * med_raw]

    def worst(prog: Dict[str, float], want: Dict[str, float]) -> float:
        med = _median([want[n] for n in kept])
        return max(abs(prog.get(n, 0.0) - want[n]) / max(want[n], med) for n in kept)

    return {"loss_gap": loss_gap, "grad_gap": worst(prog_g1, ref_g1),
            "update_gap": worst(prog_change, ref_change),
            "left_out": float(len(ref_raw1) - len(kept))}
