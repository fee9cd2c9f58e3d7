"""PyTorch port: beam search against the JAX package's reorder-free loop.

Same weights (numpy bridge), same seeded inputs, f32, test-tiny:
``multi_head_attention_beam_cache`` and ``decode_step_beam`` equal JAX's on
the same cache, ancestry table and position within 1e-5; beam tokens equal
JAX's v2 loop for beam 3 with patience 1 and 2, length penalty None and
1.0, timestamps on and off, and the float, int8 and int4 cross caches,
among them cases whose hypotheses finish into the pool (every id but 0-5,
EOT and the special tokens suppressed).

``avg_logprob``: within 1e-4 of JAX's where JAX's is finite. The JAX loop
reorders its pool by a one-hot einsum over sums that hold -inf for empty
slots (``whisper_ipa_tpu/decode/beam.py`` ``_merge_pool``), and 0 * -inf
makes every pooled sum NaN; the port gathers. Where JAX's is NaN, the port's
is finite and equals the chosen tokens' summed log-probabilities under the
same masks, from a teacher-forced pass of the port, over length + 1.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_ipa_tpu.models.layers as jax_layers
import whisper_ipa_tpu.models.whisper as jax_whisper
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode import decode as jax_decode
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import (
    DecodingOptions,
    apply_timestamp_rules,
    build_blank_mask,
    build_suppress_mask,
    decode,
    initial_tokens,
)
from whisper_ipa_torch.models import (
    DecoderCache,
    decode_step,
    decode_step_beam,
    decoder_logits,
    encode,
    init_cache,
    params_from_numpy,
)
from whisper_ipa_torch.models.layers import multi_head_attention_beam_cache
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
K = 3
STEP_ATOL = 1e-5
LOGPROB_ATOL = 1e-4


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
    return rng.standard_normal((3, 2 * CFG.n_audio_ctx, CFG.n_mels)).astype(
        np.float32)


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def jtok():
    return jax_get_tokenizer(multilingual=True, language="en")


def _ancestry(rng, B, n_ctx, pos):
    """A random ancestry table whose row at ``pos`` is each beam's own."""
    anc = rng.integers(0, K, (B, K, n_ctx))
    anc[:, :, pos] = np.arange(K)
    return anc


def test_beam_cache_attention_matches_jax():
    rng = np.random.default_rng(1)
    B, n_ctx, d, H, pos = 2, 12, 64, 2, 7

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k_new, v_new = r(B, K, d), r(B, K, d), r(B, K, d)
    k_cache, v_cache = r(B, K, n_ctx, d), r(B, K, n_ctx, d)
    anc = _ancestry(rng, B, n_ctx, pos)
    sel = np.where((anc[:, :, None, :] == np.arange(K)[None, None, :, None])
                   & (np.arange(n_ctx) < pos), 0.0, -np.inf).astype(np.float32)
    args = (q, k_cache, v_cache, k_new, v_new)
    want = np.asarray(jax_layers.multi_head_attention_beam_cache(
        *map(jnp.asarray, args), H, jnp.asarray(sel)))
    got = multi_head_attention_beam_cache(
        *map(torch.from_numpy, args), H, torch.from_numpy(sel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("cache_kind", ["float", "int8", "int4"])
def test_decode_step_beam_matches_jax(params, jax_params, cache_kind):
    """One beam step on the same (JAX-built) cache: logits and the K/V it
    writes at ``pos``."""
    rng = np.random.default_rng(2)
    B, n_ctx, pos = 2, 12, 6
    feats = rng.standard_normal((B, CFG.n_audio_ctx, CFG.n_text_state)).astype(
        np.float32)
    kw = dict(cross_kv_int8=cache_kind == "int8",
              cross_kv_int4=cache_kind == "int4")
    jcache = jax_whisper.init_cache(jax_params, JCFG, jnp.asarray(feats),
                                    max_len=n_ctx, **kw)
    L, d = CFG.n_text_layer, CFG.n_text_state
    self_k = rng.standard_normal((L, B * K, n_ctx, d)).astype(np.float32)
    self_v = rng.standard_normal((L, B * K, n_ctx, d)).astype(np.float32)
    jcache = jcache._replace(self_k=jnp.asarray(self_k),
                             self_v=jnp.asarray(self_v))
    cache = DecoderCache(*(None if x is None else torch.from_numpy(np.array(x))
                           for x in jcache))
    anc = _ancestry(rng, B, n_ctx, pos)
    tokens = rng.integers(0, CFG.n_vocab, (B, K))

    want, jnew = jax_whisper.decode_step_beam(
        jax_params, JCFG, jnp.asarray(tokens, jnp.int32), jcache, pos,
        jnp.asarray(anc, jnp.int32))
    with torch.inference_mode():
        got, cache = decode_step_beam(params, CFG, torch.from_numpy(tokens),
                                      cache, pos, torch.from_numpy(anc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STEP_ATOL)
    for ours, theirs in ((cache.self_k, jnew.self_k), (cache.self_v, jnew.self_v)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=STEP_ATOL)


def _few_ids(tok):
    """Every text id but 0-5 suppressed: hypotheses end early."""
    return dict(suppress_tokens=list(range(6, tok.eot)), suppress_blank=False)


# (timestamps, cache, length penalty, patience, few ids): each value of each
# axis at least twice, five cases finishing into the pool
BEAM_CASES = [
    (False, "float", None, None, True),
    (False, "float", 1.0, 2.0, True),
    (True, "float", 1.0, None, True),
    (True, "int8", None, 2.0, True),
    (False, "int4", 1.0, None, True),
    (True, "int4", None, None, False),
    (False, "int8", 1.0, None, False),
    (True, "float", None, 2.0, False),
]


def _teacher_forced_avg(params, mel_row, prefix, seq, opts, tok, cache_kind):
    """sum(log p(token)) over ``seq`` and the final EOT under the beam's
    masks (suppress; blank at the first position; the timestamp grammar),
    from one teacher-forced pass, over len(seq) + 1. The float cache takes
    ``decoder_logits``; a quantized one ``decode_step`` over the whole
    sequence with that cache, so both read the cross K/V the beam read."""
    tb = tok.timestamp_begin
    full = prefix + seq + [tok.eot]
    n_prefix = len(prefix)
    with torch.inference_mode():
        feats = encode(params, CFG, torch.from_numpy(mel_row[None]))
        tokens = torch.tensor([full])
        if cache_kind == "float":
            logits = decoder_logits(params, CFG, tokens, feats)[0]
        else:
            cache = init_cache(params, CFG, feats, max_len=len(full),
                               cross_kv_int8=cache_kind == "int8",
                               cross_kv_int4=cache_kind == "int4")
            logits = decode_step(params, CFG, tokens, cache, 0)[0][0]
    suppress = torch.from_numpy(build_suppress_mask(tok, opts, CFG.n_vocab))
    blank = torch.from_numpy(build_blank_mask(tok, CFG.n_vocab))
    vocab = torch.arange(CFG.n_vocab)
    total = 0.0
    for s in range(len(seq) + 1):
        row = logits[n_prefix - 1 + s] + suppress
        if s == 0 and opts.suppress_blank:
            row = row + blank
        if not opts.without_timestamps:
            seen = [t for t in seq[:s] if t >= tb]
            row = apply_timestamp_rules(
                row[None], vocab, s, torch.tensor([full[n_prefix - 1 + s]]),
                torch.tensor([full[n_prefix - 2 + s]]),
                torch.tensor([seen[-1] if seen else tb - 1]), eot=tok.eot,
                timestamp_begin=tb, max_initial_ts_index=50)[0]
        total += float(torch.log_softmax(row, -1)[full[n_prefix + s]])
    return total / (len(seq) + 1)


@pytest.mark.parametrize("ts,cache_kind,lp,patience,few", BEAM_CASES)
def test_beam_tokens_match_jax_v2(params, jax_params, mel, tok, jtok, ts,
                                  cache_kind, lp, patience, few):
    kw = dict(language="en", beam_size=K, sample_len=8,
              without_timestamps=not ts, length_penalty=lp, patience=patience,
              kv_int8=cache_kind == "int8", kv_int4=cache_kind == "int4",
              **(_few_ids(tok) if few else {}))
    ref = jax_decode(jax_params, JCFG, jnp.asarray(mel), JaxOptions(**kw),
                     tokenizer=jtok)
    opts = DecodingOptions(**kw)
    ours = decode(params, CFG, mel, opts, tokenizer=tok)
    assert len(ours) == len(ref) == len(mel)
    prefix = initial_tokens(tok, opts)
    n_nan = 0
    for b, (a, r) in enumerate(zip(ours, ref)):
        assert a.tokens == r.tokens
        assert a.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-5)
        assert np.isfinite(a.avg_logprob)
        if np.isfinite(r.avg_logprob):
            assert a.avg_logprob == pytest.approx(r.avg_logprob,
                                                  abs=LOGPROB_ATOL)
        else:  # the reference's _merge_pool NaN: a pooled hypothesis
            n_nan += 1
            want = _teacher_forced_avg(params, mel[b], prefix, a.tokens, opts,
                                       tok, cache_kind)
            assert a.avg_logprob == pytest.approx(want, abs=LOGPROB_ATOL)
    if few:
        assert n_nan > 0  # hypotheses finished into the pool
