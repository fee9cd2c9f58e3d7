"""PyTorch port: the learning path on the CPU.

The port's counterparts of ``tests/test_end_to_end_learning.py`` (a micro
Whisper overfits one synthetic utterance and greedy decoding returns it)
and of ``tests/test_word_timestamps.py``'s DTW oracle: the micro model
trained 400 steps at lr 3e-3 on eight synthesized utterances from the
reference test's starting weights (the JAX package's seed-0 init), its
cross-attention phone times held against the synthesizer's true
boundaries. The reference's bounds: mean error <= 80 ms, p90 <= 160 ms,
every boundary of the first utterance within 60 ms.

Two tests hold the oracle. On the reference's own trajectory (the JAX
package's ``train_step``, the same 400 steps) the port's phone times equal
JAX's within 1e-6 s and meet all three bounds. Trained by the port alone,
the model reaches loss < 0.05 and meets the mean and p90 bounds; the first
utterance's 60 ms is not gated there. The trajectory is chaotic past ~80
steps: from the seed-0 weights times (1 + 1e-7 N(0, 1)), a rounding-sized
change, the JAX package's first-utterance error is 120 or 240 ms in six of
eight draws, its mean over 80 ms in four and its p90 over 160 ms in six,
and the port's draws fall in the same range
(``perf/torch_dtw_oracle_spread.py``). The port's own run is one such draw.

A 20-step trajectory holds the port's ``train_step`` against the JAX
package's on the oracle's eight mels from the same weights (losses within
1e-4 relative). ``IPADataset.precompute_mels`` (the mel cache filled on a
device: K1 on CUDA, its plain version here) writes what ``mel()`` would,
within one float16 step.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from whisper_ipa_torch.audio import log_mel_spectrogram
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.data.synth import (
    synthesize_ipa,
    synthesize_phonemes_with_alignment,
)
from whisper_ipa_torch.decode import DecodingOptions, decode, phone_timestamps
from whisper_ipa_torch.metrics.segment import tokenize_ipa
from whisper_ipa_torch.models import init_params, params_from_numpy
from whisper_ipa_torch.tokenizer import get_tokenizer
from whisper_ipa_torch.train import create_train_state, train_step

torch.set_num_threads(1)

# the JAX tests' micro model: 64 wide, 2 heads, 2 layers, 1.28 s windows
CFG = replace(
    CONFIGS["test-tiny"],
    n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_text_state=64, n_text_head=2, n_text_layer=2,
    n_audio_ctx=64, n_text_ctx=32,
)
WINDOW_SAMPLES = CFG.n_audio_ctx * 2 * 160  # mel frames = 2*ctx, hop 160
LR = 3e-3
ORACLE_IPAS = ["kæt", "sip", "mus", "tasa", "pini", "suk", "ami", "kusa"]
ORACLE_STEPS = 400
ORACLE_LOSS = 0.05
PARITY_STEPS = 20
PARITY_RTOL = 1e-4
TIME_ATOL = 1e-6  # seconds, the port's phone times against JAX's


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


def window_mel(audio: np.ndarray) -> np.ndarray:
    padded = np.zeros(WINDOW_SAMPLES, np.float32)
    padded[: len(audio)] = audio[:WINDOW_SAMPLES]
    return log_mel_spectrogram(padded, n_mels=CFG.n_mels)


def token_rows(tok, ipas):
    seqs = [list(tok.sot_sequence_including_notimestamps) + tok.encode(ipa)
            + [tok.eot] for ipa in ipas]
    tokens = np.full((len(seqs), max(map(len, seqs))), tok.eot, np.int64)
    for i, s in enumerate(seqs):
        tokens[i, : len(s)] = s
    return tokens


def jax_config():
    from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS

    return replace(
        JAX_CONFIGS["test-tiny"],
        n_audio_state=64, n_audio_head=2, n_audio_layer=2,
        n_text_state=64, n_text_head=2, n_text_layer=2,
        n_audio_ctx=64, n_text_ctx=32,
    )


@pytest.fixture(scope="module")
def jax_init_flat():
    """The JAX package's seed-0 init of the micro model, as numpy."""
    from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
    from whisper_ipa_tpu.models import init_params as jax_init_params

    return {k: np.asarray(v)
            for k, v in jax_flatten_params(
                jax_init_params(jax_config(), seed=0)).items()}


def build_oracle_set(tok):
    """The oracle's eight utterances: (mels, tokens, true alignments)."""
    mels, aligns = [], []
    for i, ipa in enumerate(ORACLE_IPAS):
        audio, al = synthesize_phonemes_with_alignment(tokenize_ipa(ipa),
                                                       seed=i)
        mels.append(window_mel(audio))
        aligns.append(al)
    return np.stack(mels), token_rows(tok, ORACLE_IPAS), aligns


@pytest.fixture(scope="module")
def oracle_set(tok):
    return build_oracle_set(tok)


@pytest.fixture(scope="module")
def jax_trained(tok, oracle_set, jax_init_flat):
    """The reference test's own trajectory: the JAX package's
    ``train_step``, ORACLE_STEPS from its seed-0 init. Returns (the losses
    of every step, the final JAX params)."""
    import jax.numpy as jnp

    from whisper_ipa_tpu.models import unflatten_params as jax_unflatten
    from whisper_ipa_tpu.train import create_train_state as jax_create_state
    from whisper_ipa_tpu.train import train_step as jax_train_step

    jcfg = jax_config()
    mels, tokens, _ = oracle_set
    jstate, jtx = jax_create_state(
        jax_unflatten({k: jnp.asarray(v) for k, v in jax_init_flat.items()}),
        learning_rate=LR, freeze_encoder=False)
    jmel, jtok = jnp.asarray(mels), jnp.asarray(tokens.astype(np.int32))
    losses = []
    for _ in range(ORACLE_STEPS):
        jstate, loss = jax_train_step(jstate, jmel, jtok, jcfg, jtx, tok.eot,
                                      freeze_encoder=False)
        losses.append(float(loss))
    return losses, jstate.params


def test_overfit_one_utterance_then_transcribe(tok):
    ipa = "kæt"
    mel = torch.from_numpy(window_mel(synthesize_ipa(ipa, seed=0)))[None]
    tokens = torch.from_numpy(token_rows(tok, [ipa]))
    # encoder unfrozen: random encoder features carry no information about
    # the audio otherwise
    state, tx = create_train_state(init_params(CFG, seed=0),
                                   learning_rate=LR, freeze_encoder=False)
    losses, decoded = [], None
    for step in range(400):
        state, loss = train_step(state, mel, tokens, CFG, tx, tok.eot,
                                 freeze_encoder=False)
        if step % 50 == 49:
            losses.append(float(loss))
            decoded = decode(
                state.params, CFG, mel,
                DecodingOptions(language="en", without_timestamps=True,
                                sample_len=tokens.shape[1]),
                tokenizer=tok,
            )[0].text.strip()
            if decoded == ipa and losses[-1] < 0.1:
                break
    assert decoded == ipa, (
        f"model failed to learn the utterance: got {decoded!r}, "
        f"losses {losses}")
    assert losses[-1] < 0.5, f"loss stayed high: {losses}"


def test_dtw_recovers_true_phone_boundaries(tok, oracle_set, jax_init_flat):
    mels, tokens, aligns = oracle_set
    mel = torch.from_numpy(mels)
    tokens = torch.from_numpy(tokens)
    state, tx = create_train_state(params_from_numpy(jax_init_flat),
                                   learning_rate=LR, freeze_encoder=False)
    for _ in range(ORACLE_STEPS):
        state, loss = train_step(state, mel, tokens, CFG, tx, tok.eot,
                                 freeze_encoder=False)
    assert float(loss) < ORACLE_LOSS

    errors = []
    for i, ipa in enumerate(ORACLE_IPAS):
        seconds = aligns[i][-1][2]
        ts = phone_timestamps(state.params, CFG, tok.encode(ipa), mel[i][None],
                              tokenizer=tok, audio_seconds=seconds)
        assert [d["phone"] for d in ts] == [a[0] for a in aligns[i]]
        assert all(0.0 <= d["start"] <= d["end"] <= seconds for d in ts)
        assert all(a["start"] <= b["start"] for a, b in zip(ts, ts[1:]))
        for (phone, start, end), d in zip(aligns[i], ts):
            errors += [abs(d["start"] - start), abs(d["end"] - end)]
    errors = np.array(errors)
    assert errors.mean() <= 0.08, errors.mean()
    assert np.percentile(errors, 90) <= 0.16, np.percentile(errors, 90)


def test_dtw_on_the_reference_trajectory_meets_every_bound(
        tok, oracle_set, jax_trained):
    from whisper_ipa_tpu.decode import phone_timestamps as jax_phone_timestamps
    from whisper_ipa_tpu.models import flatten_params as jax_flatten_params

    mels, _, aligns = oracle_set
    losses, jparams = jax_trained
    assert losses[-1] < ORACLE_LOSS
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jax_flatten_params(jparams).items()})
    jcfg = jax_config()
    errors = []
    for i, ipa in enumerate(ORACLE_IPAS):
        seconds = aligns[i][-1][2]
        ts = phone_timestamps(params, CFG, tok.encode(ipa),
                              torch.from_numpy(mels[i][None]), tokenizer=tok,
                              audio_seconds=seconds)
        want = jax_phone_timestamps(jparams, jcfg, tok.encode(ipa),
                                    mels[i][None], tokenizer=tok,
                                    audio_seconds=seconds)
        assert [d["phone"] for d in ts] == [d["phone"] for d in want] == [
            a[0] for a in aligns[i]]
        for d, w in zip(ts, want):
            assert d["start"] == pytest.approx(w["start"], abs=TIME_ATOL)
            assert d["end"] == pytest.approx(w["end"], abs=TIME_ATOL)
        for (phone, start, end), d in zip(aligns[i], ts):
            errors += [abs(d["start"] - start), abs(d["end"] - end)]
            if i == 0:  # the reference's one-frame bound on the clean CVC
                assert abs(d["start"] - start) <= 0.06, (phone, d)
                assert abs(d["end"] - end) <= 0.06, (phone, d)
    errors = np.array(errors)
    assert errors.mean() <= 0.08, errors.mean()
    assert np.percentile(errors, 90) <= 0.16, np.percentile(errors, 90)


def test_train_steps_match_jax(tok, oracle_set, jax_init_flat, jax_trained):
    mels, tokens, _ = oracle_set
    want = jax_trained[0][:PARITY_STEPS]

    state, tx = create_train_state(params_from_numpy(jax_init_flat),
                                   learning_rate=LR,
                                   freeze_encoder=False)
    mel, toks = torch.from_numpy(mels), torch.from_numpy(tokens)
    got = []
    for _ in range(PARITY_STEPS):
        state, loss = train_step(state, mel, toks, CFG, tx, tok.eot,
                                 freeze_encoder=False)
        got.append(float(loss))
    rel = np.abs(np.array(got) - want) / np.abs(want)
    assert rel.max() < PARITY_RTOL, (got, want)
    assert want[-1] < want[0]  # the trajectory goes somewhere


def test_precompute_mels_fills_the_cache(tmp_path):
    import json

    from whisper_ipa_torch.audio import write_wav
    from whisper_ipa_torch.data import create_data_loader

    entries = []
    for i, ipa in enumerate(["kæt", "sip", "mus"]):
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, synthesize_ipa(ipa, seed=i))
        entries.append({"audio_path": path, "ipa_transcription": ipa})
    entries.append(dict(entries[0]))  # a repeated file is computed once
    split = str(tmp_path / "split.json")
    with open(split, "w") as f:
        json.dump(entries, f, ensure_ascii=False)
    device = create_data_loader(split, mel_cache_dir=str(tmp_path / "dev"))
    host = create_data_loader(split, mel_cache_dir=str(tmp_path / "host"))
    assert device.precompute_mels("cpu", batch_size=2) == 3
    assert device.precompute_mels("cpu") == 0  # all cached
    for i in range(len(entries)):
        cached = np.load(device._cache_path(entries[i]["audio_path"]))
        assert cached.dtype == np.float16 and cached.shape == (3000, 80)
        host.mel(i)  # computed on the host and cached as float16
        want = np.load(host._cache_path(entries[i]["audio_path"]))
        step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
        assert (np.abs(cached.astype(np.float32) - want.astype(np.float32))
                <= step).all()
        np.testing.assert_array_equal(device.mel(i), cached.astype(np.float32))
    with pytest.raises(ValueError, match="mel_cache_dir"):
        create_data_loader(split).precompute_mels("cpu")
