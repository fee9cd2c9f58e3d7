"""PyTorch port: data loading, metrics and language detection against the
JAX package on the CPU.

The port carries its own copies of the host modules (audio, tokenizer,
metrics); these tests hold the copies and the loader built on them to the
JAX package's on the same files and seeds.
"""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.audio import write_wav
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.data import PrefetchLoader as JaxPrefetchLoader
from whisper_ipa_tpu.data import create_data_loader as jax_create_data_loader
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode import decode as jax_decode
from whisper_ipa_tpu.decode.decoding import detect_language as jax_detect_language
from whisper_ipa_tpu.metrics import evaluate_batch as jax_evaluate_batch
from whisper_ipa_tpu.models import encode as jax_encode
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.data import PrefetchLoader, create_data_loader
from whisper_ipa_torch.decode import DecodingOptions, decode, detect_language
from whisper_ipa_torch.metrics import evaluate_batch
from whisper_ipa_torch.models import encode, params_from_numpy
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
IPAS = ["kæt", "bʌtn̩", "ə̥tʃ", "aːm", "ɡɯɣ", "n̩æp", "t͡ʃiːz", "ŋ̊ʷa"]


def write_dataset(root, n=6, seconds=0.5, seed=0):
    """Seeded noise-and-tone WAVs + the pipeline's JSON schema."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n):
        t = np.arange(int(seconds * 16000)) / 16000
        audio = 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
        audio += 0.02 * rng.standard_normal(t.shape)
        path = os.path.join(root, f"utt{i}.wav")
        write_wav(path, audio.astype(np.float32))
        entries.append({"audio_path": path, "ipa_transcription": IPAS[i % 8],
                        "speaker_id": f"spk{i}"})
    path = os.path.join(root, "dataset.json")
    with open(path, "w") as f:
        json.dump(entries, f, ensure_ascii=False)
    return path


@pytest.fixture(scope="module")
def dataset_json(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("ds")))


def test_get_batch_matches_jax(dataset_json):
    """Tokens identical; mels within 1e-5 (the same NumPy log-mel copy)."""
    ours = create_data_loader(dataset_json).get_batch([3, 0, 5], pad_tokens_to=16)
    ref = jax_create_data_loader(dataset_json).get_batch([3, 0, 5], pad_tokens_to=16)
    assert np.array_equal(ours["tokens"], ref["tokens"])
    assert ours["tokens"].shape == (3, 16)
    assert ours["mel_features"].shape == ref["mel_features"].shape == (3, 3000, 80)
    assert np.max(np.abs(ours["mel_features"] - ref["mel_features"])) < 1e-5
    assert ours["ipa_texts"] == ref["ipa_texts"]


def test_jsonl_and_mel_cache_match_jax(dataset_json, tmp_path):
    """JSON lines load the same entries; the float16 mel cache files have
    the same names and contents."""
    entries = json.load(open(dataset_json))
    jsonl = str(tmp_path / "data.jsonl")
    with open(jsonl, "w") as f:
        for e in entries:
            f.write(json.dumps(e, ensure_ascii=False) + "\n")
    ours = create_data_loader(jsonl, mel_cache_dir=str(tmp_path / "a"))
    ref = jax_create_data_loader(jsonl, mel_cache_dir=str(tmp_path / "b"))
    assert ours.data == ref.data == entries
    ours.mel(1), ref.mel(1)
    a, b = sorted(os.listdir(tmp_path / "a")), sorted(os.listdir(tmp_path / "b"))
    assert a == b and len(a) == 1
    assert np.array_equal(np.load(tmp_path / "a" / a[0]), np.load(tmp_path / "b" / b[0]))


@pytest.mark.parametrize("fixed", [None, 12])
def test_prefetch_order_matches_jax(dataset_json, fixed):
    """The same seed samples the same batches, padded to the same widths
    (power-of-two buckets, or a fixed width)."""
    ds, jds = create_data_loader(dataset_json), jax_create_data_loader(dataset_json)
    ours = PrefetchLoader(ds, 4, 5, seed=7, fixed_token_len=fixed)
    ref = JaxPrefetchLoader(jds, 4, 5, seed=7, fixed_token_len=fixed)
    try:
        got, want = list(ours), list(ref)
    finally:
        ours.close()
        ref.close()
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a["audio_paths"] == b["audio_paths"]
        assert np.array_equal(a["tokens"], b["tokens"])


def test_precompute_features_uses_the_port_encoder(dataset_json, tmp_path):
    """The cached features are this package's encoder outputs in float16,
    within float16 rounding of the JAX encoder's on the same weights."""
    flat = {
        k: np.asarray(v)
        for k, v in jax_flatten_params(
            jax_init_params(JAX_CONFIGS["test-tiny"], seed=0)
        ).items()
    }
    cfg = CONFIGS["test-tiny"]
    ds = create_data_loader(dataset_json)
    n = ds.precompute_features(
        params_from_numpy(flat), cfg, str(tmp_path), batch_size=4,
        dtype_name="float32",
    )
    assert n == 6
    feats = ds.get_batch([2, 4])["mel_features"]
    assert feats.shape == (2, cfg.n_audio_ctx, cfg.n_audio_state)
    mels = jax_create_data_loader(dataset_json).get_batch([2, 4])["mel_features"]
    ref = np.asarray(
        jax_encode(
            jax_init_params(JAX_CONFIGS["test-tiny"], seed=0),
            JAX_CONFIGS["test-tiny"], jnp.asarray(mels),
        )
    )
    assert np.max(np.abs(feats - ref)) <= 2e-3 * np.max(np.abs(ref))


def test_metrics_match_jax():
    refs = ["kæt", "bʌtn̩", "t͡ʃiːz", "ə̥tʃ", "", "aːm"]
    hyps = ["kat", "bʌtn", "tʃiz", "ə̥tʃ", "a", ""]
    ours, ref = evaluate_batch(refs, hyps), jax_evaluate_batch(refs, hyps)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-12)


# -- language detection -------------------------------------------------------

@pytest.fixture(scope="module")
def shared():
    jax_params = jax_init_params(JCFG, seed=0)
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((3, 2 * CFG.n_audio_ctx, CFG.n_mels)).astype(np.float32)
    return jax_params, params_from_numpy(flat), mel


def test_detect_language_matches_jax(shared):
    """Language probabilities within 1e-5 of the JAX package's (f32)."""
    jax_params, params, mel = shared
    with torch.inference_mode():
        feats = encode(params, CFG, torch.from_numpy(mel))
    jfeats = jax_encode(jax_params, JCFG, jnp.asarray(mel))
    codes, probs = detect_language(params, CFG, feats, get_tokenizer())
    jcodes, jprobs = jax_detect_language(jax_params, JCFG, jfeats, jax_get_tokenizer())
    assert codes == jcodes and len(codes) == 3
    for a, b in zip(probs, jprobs):
        assert a.keys() == b.keys() and len(a) == 99
        np.testing.assert_allclose(
            [a[c] for c in b], [b[c] for c in b], rtol=0, atol=1e-5
        )


def test_decode_without_language_matches_jax(shared):
    """decode(language=None) detects per row and then decodes: tokens and
    languages identical to the JAX package's."""
    jax_params, params, mel = shared
    kw = dict(language=None, without_timestamps=True, sample_len=12)
    ours = decode(params, CFG, mel, DecodingOptions(**kw), tokenizer=get_tokenizer())
    ref = jax_decode(
        jax_params, JCFG, jnp.asarray(mel), JaxOptions(**kw),
        tokenizer=jax_get_tokenizer(),
    )
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
    assert [r.language for r in ours] == [r.language for r in ref]
