"""PyTorch port: long-form transcription and phone timestamps against the
JAX package.

Same weights (numpy bridge; the text-token embeddings past the 256 byte
tokens zeroed so that the random decoder emits bytes, which decode to
text), same seeded 70 s waveform (three 30 s windows), f32, test-tiny at
the full 1500-frame encoder. ``transcribe`` at temperature 0 equals JAX's
(texts, tokens, segment and phone bounds) in the batched mode,
``condition_on_previous_text``, ``sequential_timestamps`` and
``word_timestamps``; with a log-probability gate that fails some windows,
the same windows are retried as in JAX (the sampled retries are compared
by structure only: torch cannot draw jax.random's numbers).
``decoder_cross_attentions`` equals JAX's within 1e-5, ``median_filter`` /
``dtw_path`` / ``chunk_audio`` / ``parse_timestamp_segments`` exactly, and
``phone_timestamps`` within 1e-6 s. The port's windows go through its
log-mel (K1's plain version on the CPU), the reference's through its host
NumPy log-mel.
"""

import importlib
from dataclasses import replace
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_ipa_tpu.decode.word_timestamps as jax_wt
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import transcribe as jax_transcribe
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.whisper import (
    decoder_cross_attentions as jax_cross_attentions,
)
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.audio import SAMPLE_RATE
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import chunk_audio, phone_timestamps, transcribe
from whisper_ipa_torch.decode.transcribe import parse_timestamp_segments
from whisper_ipa_torch.decode.word_timestamps import dtw_path, median_filter
from whisper_ipa_torch.models import decoder_cross_attentions, params_from_numpy
from whisper_ipa_torch.tokenizer import get_tokenizer

jax_tr = importlib.import_module("whisper_ipa_tpu.decode.transcribe")
port_tr = importlib.import_module("whisper_ipa_torch.decode.transcribe")

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_text_ctx=64)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_text_ctx=64)
SECONDS = 70.0
ATTN_ATOL = 1e-5
TIME_ATOL = 1e-6  # seconds


@pytest.fixture(scope="module")
def jax_params():
    p = jax_init_params(JCFG, seed=0)
    emb = np.array(p["decoder"]["token_embedding"])
    emb[256:50257] = 0.0
    p["decoder"]["token_embedding"] = jnp.asarray(emb)
    return p


@pytest.fixture(scope="module")
def params(jax_params):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    return params_from_numpy(flat)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(0)
    t = np.arange(int(SECONDS * SAMPLE_RATE)) / SAMPLE_RATE
    return (0.3 * np.sin(2 * np.pi * 220.0 * t) * np.sin(2 * np.pi * 0.3 * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def jtok():
    return jax_get_tokenizer(multilingual=True, language="en")


def _assert_same_transcript(got, want):
    assert got["text"] == want["text"] and got["language"] == want["language"]
    assert len(got["segments"]) == len(want["segments"])
    for a, b in zip(got["segments"], want["segments"]):
        assert a.keys() == b.keys()
        assert a["text"] == b["text"] and list(a["tokens"]) == list(b["tokens"])
        assert a["id"] == b["id"] and a["temperature"] == b["temperature"]
        assert a["start"] == pytest.approx(b["start"], abs=TIME_ATOL)
        assert a["end"] == pytest.approx(b["end"], abs=TIME_ATOL)
        assert a["avg_logprob"] == pytest.approx(b["avg_logprob"], abs=1e-4)
        assert a["no_speech_prob"] == pytest.approx(b["no_speech_prob"],
                                                    abs=1e-5)
        assert len(a.get("phones", [])) == len(b.get("phones", []))
        for p, q in zip(a.get("phones", []), b.get("phones", [])):
            assert p["phone"] == q["phone"]
            assert p["start"] == pytest.approx(q["start"], abs=TIME_ATOL)
            assert p["end"] == pytest.approx(q["end"], abs=TIME_ATOL)


@pytest.mark.parametrize("mode", [
    dict(),
    dict(condition_on_previous_text=True),
    dict(sequential_timestamps=True),
    dict(word_timestamps=True),
], ids=["batched", "conditioned", "sequential-timestamps", "word-timestamps"])
def test_transcribe_matches_jax(params, jax_params, audio, tok, jtok, mode):
    # the special tokens suppressed too: text between the timestamps
    specials = list(range(tok.eot + 1, tok.timestamp_begin))
    kw = dict(language="en", temperature=(0.0,), sample_len=12,
              suppress_tokens=list(range(256, tok.eot)) + specials, **mode)
    want = jax_transcribe(jax_params, JCFG, audio, tokenizer=jtok, **kw)
    got = transcribe(params, CFG, audio, tokenizer=tok, **kw)
    _assert_same_transcript(got, want)
    assert got["text"]  # the byte-token decoder emits text
    if mode.get("word_timestamps"):
        phones = [p for s in got["segments"] for p in s["phones"]]
        assert phones and all(0.0 <= p["start"] <= p["end"] <= SECONDS
                              for p in phones)
    if not mode.get("sequential_timestamps"):
        assert len(got["segments"]) == 3  # one a window


def _spy(module, calls):
    real = module.decode

    def spy(params_, cfg_, mel_, options_, tokenizer=None):
        out = real(params_, cfg_, mel_, options_, tokenizer=tokenizer)
        calls.append((options_.temperature, len(mel_),
                      [round(r.avg_logprob, 3) for r in out]))
        return out

    return mock.patch.object(module, "decode", side_effect=spy)


def test_ladder_retries_the_windows_jax_retries(params, jax_params, audio,
                                                tok, jtok):
    kw = dict(language="en", sample_len=12, compression_ratio_threshold=None,
              no_speech_threshold=None)
    first = transcribe(params, CFG, audio, tokenizer=tok, temperature=(0.0,),
                       **kw)
    lps = sorted(s["avg_logprob"] for s in first["segments"])
    # a gate between the windows' scores: some windows fail, some pass
    threshold = (lps[0] + lps[1]) / 2
    kw.update(temperature=(0.0, 0.5), logprob_threshold=threshold)
    jcalls, calls = [], []
    with _spy(jax_tr, jcalls):
        want = jax_transcribe(jax_params, JCFG, audio, tokenizer=jtok, **kw)
    with _spy(port_tr, calls):
        got = transcribe(params, CFG, audio, tokenizer=tok, **kw)
    assert [c[:2] for c in calls] == [c[:2] for c in jcalls] == [(0.0, 3), (0.5, 1)]
    assert calls[0][2] == pytest.approx(jcalls[0][2], abs=1e-3)
    temps = [s["temperature"] for s in got["segments"]]
    assert temps == [s["temperature"] for s in want["segments"]]
    assert sorted(temps) == [0.0, 0.0, 0.5]
    for a, b in zip(got["segments"], want["segments"]):
        if a["temperature"] == 0.0:
            assert a["tokens"] == b["tokens"]


def test_sequential_windows_record_their_branch(params, tok):
    """Scripted decodes walk the sequential mode through each of its
    branches; the result's "windows" names the one each window took."""
    from whisper_ipa_torch.decode import DecodingResult

    tb, text = tok.timestamp_begin, tok.encode("k")

    def result(tokens, no_speech_prob=0.0, avg_logprob=-0.1):
        return DecodingResult(
            tokens=tokens, text=tok.decode_text(
                [t for t in tokens if t < tb]), avg_logprob=avg_logprob,
            no_speech_prob=no_speech_prob, temperature=0.0,
            compression_ratio=1.0)

    scripted = iter([
        result(text, no_speech_prob=0.9, avg_logprob=-2.0),  # 0 s
        result([tb, *text, tb + 500, tb + 500]),  # 30 s, moves 10 s
        result(text),  # 40 s, moves a window
        result([tb]),  # 70 s
    ])
    with mock.patch.object(port_tr, "decode",
                           side_effect=lambda *a, **k: [next(scripted)]):
        got = transcribe(params, CFG, np.zeros(100 * SAMPLE_RATE, np.float32),
                         tokenizer=tok, temperature=(0.0,),
                         sequential_timestamps=True)
    assert [(w["start"], w["branch"]) for w in got["windows"]] == [
        (0.0, "silent"), (30.0, "timestamp pairs"), (40.0, "whole window"),
        (70.0, "no text")]
    assert [(s["start"], s["end"]) for s in got["segments"]] == [
        (30.0, 40.0), (40.0, 70.0)]


@pytest.mark.parametrize("seconds", [0.0, 1.0, 30.0, 30.01, 70.0])
def test_chunk_audio_matches_jax(seconds):
    a = np.random.default_rng(1).standard_normal(int(seconds * SAMPLE_RATE)).astype(
        np.float32)
    got, want = chunk_audio(a), jax_tr.chunk_audio(a)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("rel", [
    [0, 100, 101, 50, 50, 102, 90],   # a pair drives the advance
    [0, 100, 40],                     # no consecutive pair
    [3, 3, 100, 7, 8, 101],           # pairs, an empty segment
    [100, 101],                       # no timestamp
    [5, 200, 9, 9, 10, 10, 300, 20],  # several pairs
])
def test_parse_timestamp_segments_matches_jax(tok, rel):
    tb = tok.timestamp_begin
    tokens = [t + tb if t < 100 else t for t in rel]  # < 100: a timestamp
    assert parse_timestamp_segments(tokens, tb) == jax_tr.parse_timestamp_segments(
        tokens, tb)


def test_dtw_and_median_filter_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 37))
    for width in (1, 3, 7):
        np.testing.assert_array_equal(median_filter(x, width),
                                      jax_wt.median_filter(x, width))
    cost = rng.uniform(size=(6, 50))
    cost[2, 10:13] = 0.0  # flat valleys: ties decide the path
    for c in (cost, -median_filter(-cost, 7)):
        for ours, theirs in zip(dtw_path(c), jax_wt.dtw_path(c)):
            np.testing.assert_array_equal(ours, theirs)


def test_cross_attentions_and_phone_timestamps_match_jax(params, jax_params,
                                                         audio, tok, jtok):
    from whisper_ipa_torch.ops import log_mel_spectrogram

    mel = log_mel_spectrogram(torch.from_numpy(audio[:30 * SAMPLE_RATE])[None],
                              n_mels=CFG.n_mels)
    tokens = [104, 105, 32, 195, 166, 116, 118, 202, 131, 97]  # "hi æt…"
    prefix = list(tok.sot_sequence_including_notimestamps)
    full = prefix + tokens + [tok.eot]
    from whisper_ipa_torch.models import encode

    with torch.inference_mode():
        feats = encode(params, CFG, mel)
        logits, w = decoder_cross_attentions(params, CFG, torch.tensor([full]),
                                             feats)
    jlogits, jw = jax_cross_attentions(jax_params, JCFG,
                                       jnp.asarray([full], jnp.int32),
                                       jnp.asarray(feats.numpy()))
    assert w.shape == (CFG.n_text_layer, 1, CFG.n_text_head, len(full), 1500)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)

    got = phone_timestamps(params, CFG, tokens, feats, tokenizer=tok,
                           audio_seconds=21.5)
    want = jax_wt.phone_timestamps(jax_params, JCFG, tokens,
                                   jnp.asarray(feats.numpy()), tokenizer=jtok,
                                   audio_seconds=21.5)
    assert [p["phone"] for p in got] == [p["phone"] for p in want]
    assert len(got) >= 4
    for a, b in zip(got, want):
        assert a["start"] == pytest.approx(b["start"], abs=TIME_ATOL)
        assert a["end"] == pytest.approx(b["end"], abs=TIME_ATOL)
