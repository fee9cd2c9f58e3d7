"""PyTorch port: the micro-batching TranscriptionService on the CPU.

Requests of any length resolve, and each window's text equals ``decode()``
on the same batch of windows (tail padded with silence, as the service
pads it).
"""

from dataclasses import replace

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


@pytest.mark.parametrize(
    "kw",
    [
        dict(draft_params={}, draft_cfg=CFG),
        dict(medusa_params={}),
        dict(mesh=object()),
        dict(beam_size=2),
        dict(draft_params={}, draft_cfg=CFG, draft_k=4),
        dict(tensor_parallel=True),
    ],
)
def test_unported_options_raise(params, kw):
    match = r"item \[12\]" if kw.get("tensor_parallel") else None
    with pytest.raises(NotImplementedError, match=match):
        TranscriptionService(params, CFG, device="cpu", **kw)


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
