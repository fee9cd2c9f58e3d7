"""Offline evaluation of an audio language model in whole batches: an
evaluator scores its transcription of a held-out or zero-shot set, one
batch of 30 s windows after another, on the same audio as Whisper's cells.

Each batch runs the program's path: ``ops.log_mel_spectrogram`` (K1) and
the tower (``models.audio_llm.encode_audio``: Whisper's encoder, K2)
under the span ``encode``, then ``decode.decoding.decode`` on the frames
(the connector, the prefill of the prompt [``prompt_before`` ids; 200
audio tokens; ``prompt_after`` ids], then the greedy loop's single-token
steps) under the span ``decode``. Decoding is greedy in bfloat16; every
id from the first special one up is suppressed, so each row decodes
exactly ``sample_len`` tokens whatever the random weights say.

The mix's parameters (``traffic/<mix>.json``): ``batch`` rows a batch,
``utterance_s`` [lo, hi] stratified lengths, ``sample_len`` tokens a row,
``prompt_before`` / ``prompt_after`` ids drawn once a run from the seed,
``distinct_batches`` batches made in set-up and cycled,
``trace_batches`` batches profiled in a traced run, ``check_rows`` rows
compared (the longest utterance of a random batch among them). Each row
served is its tokens, its ``avg_logprob`` and its routes, all used by the
comparison (``harness/omni_judge.py``).

The cell reports under Whisper-large-v3's name, ``audio_s_per_s.large``:
the same audio through a larger model behind the same tower. Its facts
say what they are (``kind``) and name the spans as Whisper's cells do
where they mean the same, ``encode`` and ``decode`` (one prefill and
``new_tokens`` - 1 single-token steps a call), so that the shared readers
of the tower, the loop's steps and the device read them. A row's tokens
are ``new_tokens``, not Whisper's ``sample_len``: the Whisper-only readers
(``mfu.large``, ``k4_roofline.large``, ``decode_step_ms.large``,
``launches_per_step.large``) take that key to mean a Whisper decoder's
steps, and find nothing here. A traced run also keeps each device
operation's launch (``launches``), so that a program span's operations
are found by the host interval of its markers.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from benchmark.harness import audio, omni_judge, omni_weights, registry
from benchmark.harness.launches import profile
from benchmark.harness.trace import Spans

E2E = {"audio_s_per_s": "audio-s/s"}  # quantity -> unit


def program_config(c, dims, name):
    """The program's configuration object from the file's published keys."""
    from whisper_ipa_torch.config import AudioLLMConfig
    from benchmark.harness.program import whisper_config

    tower = whisper_config(dict(dims, decoder_layers=0), name + ".tower")
    return AudioLLMConfig(
        name=name, tower=tower, n_audio_tokens=c["whisper_query_tokens_size"],
        d_model=c["hidden_size"], n_layer=c["num_hidden_layers"],
        n_head=c["num_attention_heads"], n_kv_head=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // c["num_attention_heads"], n_vocab=c["vocab_size"],
        n_shared=c["mlp_fixed_expert_num"], shared_ffn=c["shared_intermediate_size"],
        n_routed=c["mlp_dynamic_expert_num"], routed_ffn=c["dynamic_intermediate_size"],
        n_null=c["mlp_dynamic_null_expert_num"], top_p=c["mlp_dynamic_top_p"],
        top_k=c["mlp_dynamic_top_k"], rms_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]), first_special=c["first_special_id"],
        eos=c["eos_token_id"])


def config_file(name):
    with open(registry.BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


class Driver:
    def __init__(self, ctx):
        self.ctx, self.mix, self.dims = ctx, ctx.mix, ctx.dims
        self.file = getattr(ctx, "config_file", None) or config_file(ctx.config_name)
        self.spans = Spans(False)

    def setup(self) -> None:
        from whisper_ipa_torch.decode.decoding import DecodingOptions

        c, mix, dev = self.file, self.mix, self.ctx.device
        self.cfg = program_config(c, self.dims, self.ctx.config_name)
        first = self.cfg.first_special
        rng = np.random.default_rng([self.ctx.seed, 2])
        pre = rng.integers(0, first, mix["prompt_before"]).tolist()
        post = rng.integers(0, first, mix["prompt_after"]).tolist()
        self.prompt = pre + [-1] * self.cfg.n_audio_tokens + post
        self.audio_start = len(pre)
        self.options = DecodingOptions(
            prompt=pre, prefix=post, fp16=True, sample_len=mix["sample_len"],
            suppress_tokens=list(range(first, self.cfg.n_vocab)))
        self.params = omni_weights.make_params(c, self.dims, self.ctx.seed, dev)
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

    def _batch(self, k: int, keep: bool = True):
        from whisper_ipa_torch.decode.decoding import decode
        from whisper_ipa_torch.models.audio_llm import encode_audio
        from whisper_ipa_torch.ops import log_mel_spectrogram

        with torch.inference_mode():
            with self.spans.span("encode", keep):
                mel = log_mel_spectrogram(self.waves[k], self.cfg.n_mels)
                feats = encode_audio(self.params, self.cfg, mel, torch.bfloat16)
                del mel
            with self.spans.span("decode", keep):
                results = decode(self.params, self.cfg, feats, self.options)
        return [(r.tokens, r.avg_logprob, r.routes) for r in results]

    def window(self, seconds: float, trace: bool) -> dict:
        from whisper_ipa_torch.models.audio_llm import routing_records

        self.spans = Spans(trace)
        K = self.mix["distinct_batches"]
        n_trace = self.mix["trace_batches"] if trace else 0
        self.done, walls, stretch, launches = [], [], None, []
        start = time.perf_counter()
        i = 0
        while i == 0 or i <= n_trace or time.perf_counter() - start < seconds:
            if i == 1 and n_trace:
                ks = [(1 + j) % K for j in range(n_trace)]
                out = []
                stretch, launches = profile(
                    lambda: out.extend(self._batch(k, keep=False) for k in ks))
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
        failed = sum(B - len(rows) + sum(len(r[0]) != N for r in rows)
                     for _, rows in self.done)
        c = self.file
        return {
            "attempted": attempted,
            "failed": failed,
            "unit_walls_s": walls,
            "e2e": {"audio_s_per_s": sum(self.audio_s[k] for k, _ in self.done) / elapsed},
            "facts": {
                "kind": "audio_llm_batch", "dims": self.dims, "batch": B,
                "new_tokens": N, "n_prompt": len(self.prompt),
                "llm": {k: c[k] for k in (
                    "hidden_size", "num_hidden_layers", "num_attention_heads",
                    "num_key_value_heads", "vocab_size", "shared_intermediate_size",
                    "dynamic_intermediate_size", "mlp_fixed_expert_num",
                    "mlp_dynamic_expert_num", "mlp_dynamic_null_expert_num",
                    "whisper_hidden_size", "whisper_query_tokens_size")},
                "spans": dict(self.spans.times), "walls": walls,
                "stretch": stretch, "device_name": self.ctx.device_name,
                "routing": routing_records() if trace else [],
                "launches": launches,
            },
        }

    def release(self) -> None:
        """Keep the sampled rows' waveforms, tokens and routes, free the
        rest."""
        rng = np.random.default_rng([self.ctx.seed, 1])
        n = self.mix["check_rows"]
        N = self.mix["sample_len"]
        pairs = [(i, r) for i, (_, rows) in enumerate(self.done)
                 for r, row in enumerate(rows) if len(row[0]) == N]
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
        rows = [self.done[i][1][r] for i, r in picks]
        self.sample_tokens = [row[0] for row in rows]
        self.sample_logprobs = [row[1] for row in rows]
        self.sample_routes = [row[2].cpu() for row in rows]
        self.params = self.waves = self.done = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        if not self.sample_tokens:
            return {"max_gap": float("inf"), "logprob_gap": float("inf"),
                    "forced_routes": float("inf")}
        return omni_judge.served_gaps(
            self.file, self.dims, self.ctx.seed, self.sample_waves, self.prompt,
            self.audio_start, self.sample_tokens, self.sample_logprobs,
            self.sample_routes, self.cfg.first_special, control=control)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
