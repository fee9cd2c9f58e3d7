"""Offline evaluation in whole batches: an evaluator transcribes a held-out
or zero-shot set, one batch of 30 s windows after another.

Each batch runs the program's path: ``ops.log_mel_spectrogram`` (K1) and
``models.whisper.encode`` (K2) under the span ``encode``, then
``decode.decoding.decode`` on the features (the int8 cross cache, K4 at
every single-query step) under the span ``decode``. Decoding is greedy in
bfloat16 with the prefix <|sot|><|en|><|transcribe|><|notimestamps|>;
every token at or above EOT is suppressed, so each row decodes exactly
``sample_len`` text tokens whatever the random weights say.

The mix's parameters (``traffic/<mix>.json``): ``batch`` rows a batch,
``utterance_s`` [lo, hi] stratified lengths, ``sample_len`` tokens a row,
``distinct_batches`` batches made in set-up and cycled, ``trace_batches``
batches profiled in a traced run, ``check_rows`` rows compared. Each row
served is its tokens and its ``avg_logprob``, both compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import audio, judge, weights
from benchmark.harness.program import whisper_config
from benchmark.harness.trace import Spans, profile
from benchmark.reference.tokens import special_ids, transcribe_prefix

E2E = {"audio_s_per_s": "audio-s/s"}  # quantity -> unit


class Driver:
    def __init__(self, ctx):
        self.ctx, self.mix, self.dims = ctx, ctx.mix, ctx.dims
        self.spans = Spans(False)

    def setup(self) -> None:
        from whisper_ipa_torch.decode.decoding import DecodingOptions

        d, mix, dev = self.dims, self.mix, self.ctx.device
        self.cfg = whisper_config(d, self.ctx.config_name)
        self.eot = special_ids(d["n_vocab"])["eot"]
        self.prefix = transcribe_prefix(d["n_vocab"])
        self.options = DecodingOptions(
            language="en", task="transcribe", without_timestamps=True,
            fp16=True, kv_int8=True, sample_len=mix["sample_len"],
            suppress_tokens=list(range(self.eot, d["n_vocab"])),
            suppress_blank=False)
        self.params = weights.make_params(d, self.ctx.seed, dev)
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed ^ 0x5EED)
        lo, hi = mix["utterance_s"]
        self.lengths, self.waves = [], []
        for _ in range(mix["distinct_batches"]):
            lengths = audio.stratified_lengths(mix["batch"], lo, hi, gen)
            self.lengths.append(lengths)
            self.waves.append(audio.speech_batch(lengths, gen, dev))
        self.audio_s = [float(x.sum()) for x in self.lengths]
        self._batch(0)  # the warm-up: the cell's one shape, every kernel built
        _sync(dev)

    def use_int8(self) -> None:
        """Switch to the program's own int8 linears, a witness for the
        comparison (``calibrate.py``): int8 weights (``ops.quant``) and
        int8 activations (K6) in every block linear. The activations'
        switch is the program's global; the caller turns it off."""
        from whisper_ipa_torch.models.convert import params_to
        from whisper_ipa_torch.models.layers import use_int8_activations
        from whisper_ipa_torch.ops.quant import quantize_params

        # the program quantizes on the host; the codes then move to the card
        self.params = params_to(quantize_params(self.params, bits=8), self.ctx.device)
        use_int8_activations(True)

    def _batch(self, k: int, keep: bool = True):
        from whisper_ipa_torch.decode.decoding import decode
        from whisper_ipa_torch.models.whisper import encode
        from whisper_ipa_torch.ops import log_mel_spectrogram

        with torch.inference_mode():
            with self.spans.span("encode", keep):
                mel = log_mel_spectrogram(self.waves[k], self.cfg.n_mels)
                feats = encode(self.params, self.cfg, mel, dtype=torch.bfloat16)
                del mel
            with self.spans.span("decode", keep):
                results = decode(self.params, self.cfg, feats, self.options)
        return [(r.tokens, r.avg_logprob) for r in results]

    def window(self, seconds: float, trace: bool) -> dict:
        self.spans = Spans(trace)
        K = self.mix["distinct_batches"]
        n_trace = self.mix["trace_batches"] if trace else 0
        self.done, walls, stretch = [], [], None
        start = time.perf_counter()
        i = 0
        while i == 0 or i <= n_trace or time.perf_counter() - start < seconds:
            if i == 1 and n_trace:
                ks = [(1 + j) % K for j in range(n_trace)]
                out = []
                stretch = profile(lambda: out.extend(self._batch(k, keep=False) for k in ks))
                self.done += list(zip(ks, out))
                i += n_trace
                continue
            t0 = time.perf_counter()
            self.done.append((i % K, self._batch(i % K)))
            walls.append(time.perf_counter() - t0)
            i += 1
        elapsed = time.perf_counter() - start
        N, B = self.mix["sample_len"], self.mix["batch"]
        attempted = B * len(self.done)
        # a row that never came back, or came back short or long, failed
        failed = sum(B - len(rows) + sum(len(toks) != N for toks, _ in rows)
                     for _, rows in self.done)
        return {
            "attempted": attempted,
            "failed": failed,
            "unit_walls_s": walls,
            "e2e": {"audio_s_per_s": sum(self.audio_s[k] for k, _ in self.done) / elapsed},
            "facts": {
                "kind": "eval_batch", "dims": self.dims, "batch": self.mix["batch"],
                "sample_len": N, "n_prefix": len(self.prefix),
                "spans": dict(self.spans.times), "walls": walls,
                "stretch": stretch, "device_name": self.ctx.device_name,
            },
        }

    def release(self) -> None:
        """Keep the sampled rows' waveforms and tokens, free the rest."""
        rng = np.random.default_rng([self.ctx.seed, 1])
        n = self.mix["check_rows"]
        N = self.mix["sample_len"]
        pairs = [(i, r) for i, (_, rows) in enumerate(self.done)
                 for r, (toks, _) in enumerate(rows) if len(toks) == N]
        picks = []
        if pairs:
            b = int(rng.integers(len(self.done)))
            longest = (b, int(torch.argmax(self.lengths[self.done[b][0]])))
            picks = [longest] if longest in set(pairs) else []
            rest = [p for p in pairs if p not in picks]
            order = rng.permutation(len(rest))[:max(0, n - len(picks))]
            picks += [rest[j] for j in order]
        self.sample_waves = torch.stack(
            [self.waves[self.done[i][0]][r] for i, r in picks]) if picks else None
        self.sample_tokens = [self.done[i][1][r][0] for i, r in picks]
        self.sample_logprobs = [self.done[i][1][r][1] for i, r in picks]
        self.params = self.waves = self.done = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        if not self.sample_tokens:
            return {"max_gap": float("inf"), "logprob_gap": float("inf")}
        params = weights.make_params(self.dims, self.ctx.seed, self.ctx.device)
        return judge.served_gaps(params, self.dims, self.sample_waves,
                                 self.sample_tokens, self.sample_logprobs,
                                 self.prefix, self.eot, self.options.kv_int8,
                                 control=control)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
