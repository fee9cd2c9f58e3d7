"""Decoder-only fine-tuning: the reference's recipe (encoder frozen and run
under ``no_grad`` each step, bfloat16 activations, float32 parameters and
AdamW state, per-tensor clipping) on batches of 30 s windows.

Set-up makes ``distinct_batches`` + 1 batches: seeded speech-like audio,
its log-mel through the program's ``ops.log_mel_spectrogram`` (the
trainer's mel cache), and target rows of the prefix <|sot|><|en|>
<|transcribe|><|notimestamps|>, ``n`` body ids drawn below EOT and EOT,
padded with EOT to the batch's longest. Every batch holds the same
stratified set of ``n`` in a seeded order, so every seed pads to the same
width and does the same work. The window runs chunks of C =
``distinct_batches`` steps of the program's ``train.step.train_chunk``
over batches 0..C-1, reading the losses once a chunk, as the trainer
logs; each chunk is the span ``chunk``. Set-up drives the first 1 + C
steps, which the reference then follows: one step alone on the extra
batch (the optimizer's state after it gives the first gradient), then
the window's own call, one chunk over batches 0..C-1.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import audio, judge, weights
from benchmark.harness.program import whisper_config
from benchmark.harness.trace import Spans, profile
from benchmark.reference.tokens import special_ids, transcribe_prefix

E2E = {"train_samples_per_s": "samples/s"}  # quantity -> unit
B1 = 0.9  # the configured AdamW's first-moment decay


class Driver:
    def __init__(self, ctx):
        self.ctx, self.mix, self.dims = ctx, ctx.mix, ctx.dims
        self.spans = Spans(False)

    def setup(self) -> None:
        from whisper_ipa_torch.models.convert import flatten_params
        from whisper_ipa_torch.ops import log_mel_spectrogram
        from whisper_ipa_torch.train.step import create_train_state

        d, mix, dev = self.dims, self.mix, self.ctx.device
        self.cfg = whisper_config(d, self.ctx.config_name)
        self.eot = special_ids(d["n_vocab"])["eot"]
        B, nb = mix["batch"], mix["distinct_batches"]
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed ^ 0x5EED)
        lo, hi = mix["utterance_s"]
        # batches 0..nb-1 are the window's chunk; batch nb is the first step's
        self.waves = [audio.speech_batch(audio.stratified_lengths(B, lo, hi, gen), gen, dev)
                      for _ in range(nb + 1)]
        with torch.no_grad():
            self.mels = torch.stack([log_mel_spectrogram(w, d["n_mels"]) for w in self.waves])
        self.tokens = torch.stack([self._targets(gen) for _ in range(nb + 1)])
        self.n_inputs = self.input_lengths * nb  # real decoder positions a row
        params = weights.make_params(d, self.ctx.seed, dev)
        names = {id(t): n for n, t in weights.leaves(params)}
        self.state, self.tx = create_train_state(
            params, learning_rate=mix["learning_rate"],
            max_grad_norm=mix["max_grad_norm"], freeze_encoder=True)
        flat = flatten_params(params)
        # the program's names of the trainable leaves, by the harness's
        self.trainable = {names[id(flat[n])]: n for n in self.state.opt_state.mu}

        self.order = [nb] + list(range(nb))  # the checked steps' batches
        first = self._chunk(slice(nb, nb + 1))
        self.mu1 = {h: self.state.opt_state.mu[p].norm().item() / (1 - B1)
                    for h, p in self.trainable.items()}
        chunk = self._chunk(slice(0, nb))  # the window's own call and feed
        now = dict(weights.leaves(self.state.params))
        self.p_checked = {h: now[h].clone() for h in self.trainable}
        self.losses_checked = torch.cat([first, chunk]).tolist()
        _sync(dev)

    def _targets(self, gen) -> torch.Tensor:
        """(B, S) rows: prefix, the stratified body lengths in a seeded
        order, EOT, EOT padding to the longest."""
        mix, dev = self.mix, self.ctx.device
        B = mix["batch"]
        lo, hi = mix["target_tokens"]
        body = [round(lo + (hi - lo) * i / (B - 1)) for i in range(B)]
        order = torch.randperm(B, generator=gen, device=dev).tolist()
        prefix = transcribe_prefix(self.dims["n_vocab"])
        self.input_lengths = [len(prefix) + n for n in body]
        S = len(prefix) + hi + 1
        rows = torch.full((B, S), self.eot, dtype=torch.long, device=dev)
        ids = torch.randint(0, self.eot, (B, hi), generator=gen, device=dev)
        rows[:, :len(prefix)] = torch.tensor(prefix, device=dev)
        for r, j in enumerate(order):
            rows[r, len(prefix):len(prefix) + body[j]] = ids[r, :body[j]]
        return rows

    def _chunk(self, which) -> torch.Tensor:
        from whisper_ipa_torch.train.step import train_chunk

        self.state, losses = train_chunk(
            self.state, self.mels[which], self.tokens[which], self.cfg, self.tx,
            self.eot, freeze_encoder=True, dtype_name="bfloat16")
        return losses.float().cpu()

    def window(self, seconds: float, trace: bool) -> dict:
        self.spans = Spans(trace)
        n_trace = self.mix["trace_chunks"] if trace else 0
        walls, stretch, losses = [], None, []
        every = slice(0, self.mix["distinct_batches"])
        start = time.perf_counter()
        i = 0
        while i == 0 or i <= n_trace or time.perf_counter() - start < seconds:
            if i == 1 and n_trace:
                out = []

                def traced():
                    for _ in range(n_trace):
                        with self.spans.span("chunk", keep=False):
                            out.append(self._chunk(every))

                stretch = profile(traced)
                losses += out
                i += n_trace
                continue
            t0 = time.perf_counter()
            with self.spans.span("chunk"):
                losses.append(self._chunk(every))
            walls.append(time.perf_counter() - t0)
            i += 1
        elapsed = time.perf_counter() - start
        steps = torch.cat(losses)
        B = self.mix["batch"]
        return {
            "unit_walls_s": walls,
            "attempted": int(steps.numel()),
            "failed": int((~torch.isfinite(steps)).sum()),
            "e2e": {"train_samples_per_s": steps.numel() * B / elapsed},
            "facts": {
                "kind": "finetune", "dims": self.dims, "batch": B,
                "chunk": self.mix["distinct_batches"], "n_inputs": self.n_inputs,
                "spans": dict(self.spans.times), "walls": walls,
                "stretch": stretch, "device_name": self.ctx.device_name,
            },
        }

    def release(self) -> None:
        """Keep the checked steps' inputs, free the program's state."""
        self.check_waves = [self.waves[k] for k in self.order]
        self.check_tokens = [self.tokens[k] for k in self.order]
        self.state = self.tx = self.mels = self.waves = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        mix, dev = self.mix, self.ctx.device
        start = dict(weights.leaves(weights.make_params(self.dims, self.ctx.seed, dev)))
        change = {h: (self.p_checked[h] - start[h]).norm().item() for h in self.p_checked}
        del start
        args = (self.dims, self.ctx.seed, dev, self.check_waves, self.check_tokens,
                mix["learning_rate"], mix["max_grad_norm"], mix["weight_decay"])
        ref = judge.reference_steps(*args)
        out = judge.training_readings(self.losses_checked, self.mu1, change, *ref)
        if control:
            from benchmark.reference.precision import FP8

            losses, g1, ch, _ = judge.reference_steps(*args, prec=FP8)
            ctl = judge.training_readings(losses, g1, ch, *ref)
            out.update({f"control_{k}": v for k, v in ctl.items() if k != "left_out"})
        return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

