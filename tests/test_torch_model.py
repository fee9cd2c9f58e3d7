"""PyTorch port: the Whisper model against the JAX package at test-tiny in
f32, on the same weights (through the numpy bridge) and the same inputs.

Tolerances: both sides compute in f32 and differ only in summation order,
so activations agree to ~1e-5 of their scale; 1e-4 absolute on encoder
features (unit scale after ln_post) and 2e-4 on logits (scale ~5) leave
room for that and nothing more.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.config import CONFIGS
from whisper_ipa_tpu.models import decode_step as jax_decode_step
from whisper_ipa_tpu.models import decoder_logits as jax_decoder_logits
from whisper_ipa_tpu.models import encode as jax_encode
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_cache as jax_init_cache
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_torch.models import (
    decode_step,
    decoder_logits,
    encode,
    init_cache,
    params_from_numpy,
)

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
N_MEL_FRAMES = CFG.n_audio_ctx * 2
TOKENS = np.array(
    [[50258, 50259, 50359, 50363, 100, 200],
     [50258, 50259, 50359, 50363, 300, 400]]
)
FEATURE_ATOL = 1e-4
LOGIT_ATOL = 2e-4


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    return params_from_numpy(flat)


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)


@pytest.fixture(scope="module")
def feats(params, mel):
    with torch.inference_mode():
        return encode(params, CFG, torch.from_numpy(mel))


@pytest.fixture(scope="module")
def jax_feats(jax_params, mel):
    return jax_encode(jax_params, CFG, jnp.asarray(mel))


def test_encode_matches_jax(feats, jax_feats):
    assert feats.shape == (2, CFG.n_audio_ctx, CFG.n_audio_state)
    np.testing.assert_allclose(
        feats.numpy(), np.asarray(jax_feats), atol=FEATURE_ATOL, rtol=0
    )


def test_decoder_logits_match_jax(params, jax_params, jax_feats):
    feats = torch.from_numpy(np.array(jax_feats))
    with torch.inference_mode():
        ours = decoder_logits(params, CFG, torch.from_numpy(TOKENS), feats)
    ref = np.asarray(
        jax_decoder_logits(jax_params, CFG, jnp.asarray(TOKENS), jax_feats)
    )
    assert ours.dtype == torch.float32 and ours.shape == (2, 6, CFG.n_vocab)
    np.testing.assert_allclose(ours.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_step_matches_jax(params, jax_params, jax_feats, kv_int8):
    """Prefix step then two single-token steps, float and int8 cross-KV."""
    feats = torch.from_numpy(np.array(jax_feats))
    with torch.inference_mode():
        cache = init_cache(params, CFG, feats, max_len=16, cross_kv_int8=kv_int8)
        steps = [decode_step(params, CFG, torch.from_numpy(TOKENS[:, :4]), cache, 0)[0]]
        for pos in (4, 5):
            tok = torch.from_numpy(TOKENS[:, pos:pos + 1])
            steps.append(decode_step(params, CFG, tok, cache, pos)[0])

    jcache = jax_init_cache(
        jax_params, CFG, jax_feats, max_len=16, cross_kv_int8=kv_int8
    )
    ref, jcache = jax_decode_step(jax_params, CFG, jnp.asarray(TOKENS[:, :4]), jcache, 0)
    refs = [ref]
    for pos in (4, 5):
        ref, jcache = jax_decode_step(
            jax_params, CFG, jnp.asarray(TOKENS[:, pos:pos + 1]), jcache, pos
        )
        refs.append(ref)
    for ours, ref in zip(steps, refs):
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0
        )
    # the self-KV cache the port wrote in place equals the JAX cache
    np.testing.assert_allclose(
        cache.self_k[:, :, :6].numpy(), np.asarray(jcache.self_k[:, :, :6]),
        atol=FEATURE_ATOL * 10, rtol=0,
    )


def test_init_cache_int8_matches_jax(params, jax_params, jax_feats):
    feats = torch.from_numpy(np.array(jax_feats))
    with torch.inference_mode():
        cache = init_cache(params, CFG, feats, max_len=8, cross_kv_int8=True)
    ref = jax_init_cache(jax_params, CFG, jax_feats, max_len=8, cross_kv_int8=True)
    L, B, H, Dh = CFG.n_text_layer, 2, CFG.n_text_head, CFG.n_text_head_dim
    assert cache.cross_k.shape == (L, B, H, Dh, 128)
    assert cache.cross_k_scale.shape == (L, B, H, 128)
    assert torch.all(cache.cross_k_scale[..., CFG.n_audio_ctx:] == 0)
    for ours, theirs in (
        (cache.cross_k, ref.cross_k), (cache.cross_v, ref.cross_v)
    ):
        diff = np.abs(ours.numpy().astype(np.int32) - np.asarray(theirs, np.int32))
        assert diff.max() <= 1
    for ours, theirs in (
        (cache.cross_k_scale, ref.cross_k_scale),
        (cache.cross_v_scale, ref.cross_v_scale),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=0)


def test_cached_matches_uncached(params, feats):
    """Incremental decode reproduces teacher-forced logits."""
    tokens = torch.from_numpy(TOKENS)
    with torch.inference_mode():
        full = decoder_logits(params, CFG, tokens, feats)
        cache = init_cache(params, CFG, feats, max_len=16)
        l_prefix, cache = decode_step(params, CFG, tokens[:, :4], cache, 0)
        l4, cache = decode_step(params, CFG, tokens[:, 4:5], cache, 4)
        l5, cache = decode_step(params, CFG, tokens[:, 5:6], cache, 5)
    torch.testing.assert_close(l_prefix, full[:, :4], atol=LOGIT_ATOL, rtol=0)
    torch.testing.assert_close(l4[:, 0], full[:, 4], atol=LOGIT_ATOL, rtol=0)
    torch.testing.assert_close(l5[:, 0], full[:, 5], atol=LOGIT_ATOL, rtol=0)


def test_causality(params, feats):
    """Changing a later token does not affect earlier logits."""
    t1 = torch.tensor([[50258, 50259, 50359, 50363]])
    t2 = torch.tensor([[50258, 50259, 50359, 999]])
    with torch.inference_mode():
        l1 = decoder_logits(params, CFG, t1, feats[:1])
        l2 = decoder_logits(params, CFG, t2, feats[:1])
    torch.testing.assert_close(l1[:, :3], l2[:, :3], atol=1e-5, rtol=0)
    assert not torch.allclose(l1[:, 3], l2[:, 3])
