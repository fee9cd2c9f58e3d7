"""PyTorch port: greedy decoding against the JAX package.

Same weights (numpy bridge), same mel, same options: in f32 the port's
greedy tokens must be identical to ``whisper_ipa_tpu.decode.decode`` at the
shapes of tests/test_decode.py, with the float and the int8 cross cache;
beam search and the timestamp rules too (their full parity tests are
tests/test_torch_beam.py and tests/test_torch_decode_timestamps.py).
In bf16 the two frameworks round at other places, so near-tie argmax flips
are expected; the test asks for an agreement rate instead.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode import build_blank_mask as jax_blank_mask
from whisper_ipa_tpu.decode import build_suppress_mask as jax_suppress_mask
from whisper_ipa_tpu.decode import decode as jax_decode
from whisper_ipa_tpu.decode import initial_tokens as jax_initial_tokens
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import (
    DecodingOptions,
    build_blank_mask,
    build_suppress_mask,
    decode,
    initial_tokens,
)
from whisper_ipa_torch.models import params_from_numpy
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
N_MEL_FRAMES = CFG.n_audio_ctx * 2
SAMPLE_LEN = 16
BF16_MIN_AGREEMENT = 0.5  # of token positions, over 4 rows x 16 tokens


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    return params_from_numpy(flat)


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return rng.standard_normal((4, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def jtok():
    return jax_get_tokenizer(multilingual=True, language="en")


def _options(cls, **kw):
    return cls(language="en", without_timestamps=True, sample_len=SAMPLE_LEN, **kw)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_tokens_match_jax_f32(params, jax_params, mel, tok, jtok, kv_int8):
    ref = jax_decode(
        jax_params, JCFG, jnp.asarray(mel), _options(JaxOptions, kv_int8=kv_int8),
        tokenizer=jtok,
    )
    ours = decode(
        params, CFG, mel, _options(DecodingOptions, kv_int8=kv_int8), tokenizer=tok
    )
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert a.tokens == b.tokens
        assert a.text == b.text
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-6)
        assert a.compression_ratio == b.compression_ratio


def test_eot_ends_rows_like_jax(params, jax_params, mel, tok, jtok):
    """Suppressing every text token but one forces early EOTs; the finished
    masking and the log-prob sums must match the reference's."""
    allowed = {100, tok.eot}
    suppress = [t for t in range(tok.eot + 1) if t not in allowed]
    kw = dict(suppress_tokens=suppress, suppress_blank=False)
    ref = jax_decode(
        jax_params, JCFG, jnp.asarray(mel), _options(JaxOptions, **kw), tokenizer=jtok
    )
    ours = decode(params, CFG, mel, _options(DecodingOptions, **kw), tokenizer=tok)
    for a, b in zip(ours, ref):
        assert a.tokens == b.tokens
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)


def test_bf16_agreement(params, jax_params, mel, tok, jtok):
    ref = jax_decode(
        jax_params, JCFG, jnp.asarray(mel),
        _options(JaxOptions, fp16=True, kv_int8=True), tokenizer=jtok,
    )
    ours = decode(
        params, CFG, mel, _options(DecodingOptions, fp16=True, kv_int8=True),
        tokenizer=tok,
    )
    same = total = 0
    for a, b in zip(ours, ref):
        assert len(a.tokens) == len(b.tokens) == SAMPLE_LEN  # blank EOT masked
        same += sum(x == y for x, y in zip(a.tokens, b.tokens))
        total += SAMPLE_LEN
    assert same / total >= BF16_MIN_AGREEMENT


def test_encoder_features_input(params, mel, tok):
    """decode() also takes precomputed encoder output."""
    from whisper_ipa_torch.models import encode

    opts = _options(DecodingOptions)
    with torch.inference_mode():
        feats = encode(params, CFG, torch.from_numpy(mel[:2]))
    a = decode(params, CFG, feats, opts, tokenizer=tok)
    b = decode(params, CFG, mel[:2], opts, tokenizer=tok)
    assert [r.tokens for r in a] == [r.tokens for r in b]


def test_temperature_sampling_is_seeded(params, mel, tok):
    opts = _options(DecodingOptions, temperature=1.0, seed=7)
    a = decode(params, CFG, mel[:2], opts, tokenizer=tok)
    b = decode(params, CFG, mel[:2], opts, tokenizer=tok)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert all(r.temperature == 1.0 for r in a)


def test_masks_and_prefix_match_jax(tok, jtok):
    for kw in (
        dict(without_timestamps=True),
        dict(without_timestamps=False, suppress_tokens=[-1, 5, 7]),
        dict(without_timestamps=True, suppress_tokens="", prompt="ab", prefix="c"),
    ):
        ours, theirs = DecodingOptions(**kw), JaxOptions(**kw)
        np.testing.assert_array_equal(
            build_suppress_mask(tok, ours, CFG.n_vocab),
            jax_suppress_mask(jtok, theirs, JCFG.n_vocab),
        )
        assert initial_tokens(tok, ours) == jax_initial_tokens(jtok, theirs)
    np.testing.assert_array_equal(
        build_blank_mask(tok, CFG.n_vocab), jax_blank_mask(jtok, JCFG.n_vocab)
    )


def test_best_of_at_temperature_0_is_greedy(params, jax_params, mel, tok, jtok):
    """The reference ignores best_of unless it samples: at temperature 0 the
    port's tokens equal the JAX package's for the same options and its own
    tokens without best_of."""
    kw = dict(best_of=2, temperature=0.0)
    ref = jax_decode(jax_params, JCFG, jnp.asarray(mel), _options(JaxOptions, **kw),
                     tokenizer=jtok)
    ours = decode(params, CFG, mel, _options(DecodingOptions, **kw), tokenizer=tok)
    greedy = decode(params, CFG, mel, _options(DecodingOptions), tokenizer=tok)
    assert len(ours) == len(ref) == 4
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
    assert [r.tokens for r in ours] == [r.tokens for r in greedy]


@pytest.mark.parametrize(
    "kw",
    [
        dict(beam_size=2),
        dict(best_of=3, temperature=0.5),
        dict(without_timestamps=False),
    ],
)
def test_formerly_refused_options_run(params, jax_params, mel, tok, jtok, kw):
    """Beam search, best-of sampling and the timestamp rules decode: the
    deterministic ones give JAX's tokens; best-of (torch cannot draw
    jax.random's numbers) one finite result an input, as JAX does."""
    ref = jax_decode(jax_params, JCFG, jnp.asarray(mel),
                     replace(_options(JaxOptions), **kw), tokenizer=jtok)
    ours = decode(params, CFG, mel, replace(_options(DecodingOptions), **kw),
                  tokenizer=tok)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert np.isfinite(a.avg_logprob) and a.tokens
        if kw.get("temperature", 0.0) == 0.0:
            assert a.tokens == b.tokens
            assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-6)
