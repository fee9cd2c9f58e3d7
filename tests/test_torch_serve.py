"""PyTorch port: the micro-batching TranscriptionService on the CPU.

Requests of any length resolve, and each window's text equals ``decode()``
on the same batch of windows (tail padded with silence, as the service
pads it), greedy, with beam search and with a draft model.
"""

from dataclasses import replace

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from whisper_ipa_torch.audio import N_SAMPLES, SAMPLE_RATE
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import decode
from whisper_ipa_torch.models import init_params
from whisper_ipa_torch.ops import log_mel_spectrogram
from whisper_ipa_torch.serve import TranscriptionService
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

# full-length windows (3000 mel frames) need n_audio_ctx 1500; two thin
# layers keep the CPU encoder cheap
CFG = replace(CONFIGS["test-tiny"], n_text_ctx=48)
BATCH = 2


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def service(params, tok):
    svc = TranscriptionService(
        params, CFG, device="cpu", batch_size=BATCH, max_wait_ms=2000.0,
        bf16=False, tokenizer=tok,
    )
    yield svc
    svc.close()
    assert not svc._thread.is_alive()


def _audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * SAMPLE_RATE)) * 0.1).astype(
        np.float32
    )


def test_requests_resolve_and_match_decode(service, params, tok):
    # 40 s spans two windows: batch [short, long[0]], then [long[1], pad]
    short, long_ = _audio(5.0, seed=1), _audio(40.0, seed=2)
    partials = []
    futs = [service.submit(short), service.submit(long_, on_partial=partials.append)]
    out = [f.result(timeout=300) for f in futs]
    assert [len(o["segments"]) for o in out] == [1, 2]
    assert [(p["window"], p["n_windows"]) for p in partials] == [(0, 2), (1, 2)]
    assert partials[-1]["partial_text"] == out[1]["text"]
    assert all(o["latency_sec"] > 0 for o in out)

    def window(a, i):
        w = np.zeros(N_SAMPLES, np.float32)
        part = a[i * N_SAMPLES:(i + 1) * N_SAMPLES]
        w[: len(part)] = part
        return w

    groups = [
        [window(short, 0), window(long_, 0)],
        [window(long_, 1), np.zeros(N_SAMPLES, np.float32)],
    ]
    ref = []
    for g in groups:
        mels = log_mel_spectrogram(torch.from_numpy(np.stack(g)), CFG.n_mels)
        ref.extend(decode(params, CFG, mels, service.options, tokenizer=tok))
    got = [out[0]["segments"][0], out[1]["segments"][0], out[1]["segments"][1]]
    for seg, r in zip(got, ref[:3]):
        assert seg["text"] == r.text
        assert seg["avg_logprob"] == pytest.approx(r.avg_logprob, abs=1e-6)
    assert out[1]["text"] == ref[1].text + ref[2].text
    stats = service.stats()
    assert stats["requests"] == 2 and stats["windows"] == 3
    assert stats["batches"] == 2


def _mesh(data, model):
    return SimpleNamespace(shape={"data": data, "model": model})


@pytest.mark.parametrize(
    "kw,error,match",
    [
        (dict(mesh=_mesh(1, 2), tensor_parallel=True, draft_params={},
              draft_cfg=CFG), NotImplementedError, r"item \[18\]"),
        (dict(mesh=_mesh(1, 2), tensor_parallel=True,
              medusa_params={"heads": []}), NotImplementedError,
         r"item \[18\]"),
        (dict(mesh=_mesh(3, 1), batch_size=4), ValueError,
         "divisible by the mesh's data axis"),
        (dict(mesh=_mesh(1, 2), tensor_parallel=True, quant_bits=8),
         ValueError, "not supported"),
    ],
)
def test_unported_options_raise(params, kw, error, match):
    """Over a mesh the service refuses what the reference refuses (a
    batch the data axis does not divide, quantized TP) and speculative
    decoding over a TP mesh (not ported); the multi-rank service runs in
    tests/test_torch_multirank.py."""
    with pytest.raises(error, match=match):
        TranscriptionService(params, CFG, device="cpu", **kw)


@pytest.mark.parametrize(
    "kw,message",
    [
        (dict(draft_params={}, draft_cfg=CFG, beam_size=2), "excludes beam"),
        (dict(medusa_params={"heads": []}, beam_size=2), "excludes beam"),
        (dict(draft_params={}, draft_cfg=CFG, medusa_params={"heads": []}),
         "ONE of"),
        (dict(draft_params={}), "requires draft_cfg"),
        (dict(medusa_tree=((-1, 0),)), "needs medusa_params"),
    ],
)
def test_speculative_options_rejected(params, kw, message):
    """The reference's ValueErrors for the speculative keywords."""
    with pytest.raises(ValueError, match=message):
        TranscriptionService(params, CFG, device="cpu", **kw)


def test_service_speculative_texts_equal_plain(params, tok):
    """Full 30 s windows through the service with a draft model (K 3) and
    plainly: the same texts and avg_logprobs."""
    draft = init_params(CFG, seed=5)
    rng = np.random.default_rng(9)
    clips = [(0.1 * rng.standard_normal(int(s * SAMPLE_RATE))).astype(np.float32)
             for s in (3.0, 35.0)]  # the second spans two windows
    outs = {}
    for name, kw in (("plain", {}),
                     ("draft", dict(draft_params=draft, draft_cfg=CFG,
                                    draft_k=3))):
        svc = TranscriptionService(params, CFG, device="cpu", batch_size=3,
                                   max_wait_ms=2000.0, bf16=False,
                                   tokenizer=tok, **kw)
        try:
            futs = [svc.submit(c) for c in clips]
            outs[name] = [f.result(timeout=300) for f in futs]
        finally:
            svc.close()
    for a, b in zip(outs["draft"], outs["plain"]):
        assert a["text"] == b["text"]
        assert [s["avg_logprob"] for s in a["segments"]] == pytest.approx(
            [s["avg_logprob"] for s in b["segments"]], abs=1e-5)
    assert len(outs["plain"][1]["segments"]) == 2


def test_beam_service_matches_decode(params, tok):
    """beam_size reaches the service's decode: each window's result equals
    decode() with the service's options (beam 2) on the same batch."""
    svc = TranscriptionService(params, CFG, device="cpu", batch_size=2,
                               max_wait_ms=0.0, bf16=False, tokenizer=tok,
                               beam_size=2)
    clip = _audio(3.0, seed=4)
    try:
        out = svc.submit(clip).result(timeout=300)
    finally:
        svc.close()
    assert svc.options.beam_size == 2
    group = np.zeros((2, N_SAMPLES), np.float32)
    group[0, :len(clip)] = clip
    mel = log_mel_spectrogram(torch.from_numpy(group), CFG.n_mels)
    ref = decode(params, CFG, mel, svc.options, tokenizer=tok)[0]
    assert out["text"] == ref.text
    assert out["segments"][0]["avg_logprob"] == pytest.approx(ref.avg_logprob,
                                                              abs=1e-6)


def test_draft_k_alone_is_inert(params, tok):
    """The reference's keyword: without draft_params it changes nothing, so
    the service constructs and answers as the default one does."""
    svc = TranscriptionService(params, CFG, device="cpu", batch_size=1,
                               max_wait_ms=0.0, bf16=False, tokenizer=tok,
                               draft_k=4, tensor_parallel=False)
    try:
        out = svc.submit(_audio(2.0, seed=3)).result(timeout=300)
    finally:
        svc.close()
    assert svc.draft_k == 4 and len(out["segments"]) == 1
    mel = log_mel_spectrogram(
        torch.from_numpy(np.stack([np.pad(_audio(2.0, seed=3),
                                          (0, N_SAMPLES - 2 * SAMPLE_RATE))])),
        CFG.n_mels)
    assert out["text"] == decode(params, CFG, mel, svc.options, tokenizer=tok)[0].text
