"""PyTorch port: the timestamp grammar and best-of-N against the JAX package.

Same weights (numpy bridge), same seeded mel, f32, test-tiny:
``apply_timestamp_rules`` equals JAX's on seeded logits and grammar states
(the -inf pattern exactly, finite values within 1e-6); greedy decoding with
timestamps (``without_timestamps=False``, the default) gives JAX's tokens
for the float, int8 and int4 cross caches, with a prompt and on the default
``DecodingOptions()``, ``avg_logprob`` within 1e-4 and ``no_speech_prob``
within 1e-5, and every row obeys the grammar. Best-of: the ranking picks
JAX's row on JAX's candidates (ties included); ``best_of=3`` at temperature
0.5 keeps the best of each input's own candidates (torch's generator cannot
draw jax.random's numbers, so the draws are not compared).
"""

from dataclasses import replace
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whisper_ipa_tpu.decode.decoding as jax_decoding
import whisper_ipa_torch.decode.decoding as port_decoding
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
    decode,
    rank_candidates,
    sequence_score,
)
from whisper_ipa_torch.models import params_from_numpy
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
SAMPLE_LEN = 16
RULES_ATOL = 1e-6
LOGPROB_ATOL = 1e-4
NO_SPEECH_ATOL = 1e-5


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


def _rule_states(tb):
    """(prev, prev2, last_ts) rows: text after text with no timestamp yet
    (last_ts at the sentinel), a lone timestamp, a pair, text after a
    timestamp, and two sentinel rows for the dominance case."""
    return np.array([
        [100, 101, tb - 1],
        [tb + 5, 100, tb + 5],
        [tb + 7, tb + 5, tb + 7],
        [100, tb + 5, tb + 5],
        [100, 101, tb - 1],
        [tb + 3, 200, tb + 3],
    ])


@pytest.mark.parametrize("step", [0, 3])
def test_apply_timestamp_rules_matches_jax(tok, step):
    tb = tok.timestamp_begin
    V = CFG.n_vocab
    rng = np.random.default_rng(step)
    logits = rng.standard_normal((6, V)).astype(np.float32)
    # rows 4 and 5: the timestamps' total mass beats every text token
    logits[4:, tb:] += 4.0
    states = _rule_states(tb)
    kw = dict(eot=tok.eot, timestamp_begin=tb, max_initial_ts_index=50)
    want = np.asarray(jax_decoding.apply_timestamp_rules(
        jnp.asarray(logits), jnp.arange(V), jnp.int32(step),
        *(jnp.asarray(states[:, i], jnp.int32) for i in range(3)), **kw))
    got = apply_timestamp_rules(
        torch.from_numpy(logits), torch.arange(V), step,
        *(torch.from_numpy(states[:, i]) for i in range(3)), **kw).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=RULES_ATOL)
    # the rules bite: at step 0 only the first 51 timestamps survive; after
    # a pair no timestamp; the dominance rows keep only timestamps
    if step == 0:
        assert np.isfinite(got[0, tb:tb + 51]).all()
        assert np.isinf(got[0, :tb]).all() and np.isinf(got[0, tb + 51:]).all()
    else:
        assert np.isinf(got[2, tb:]).all() and np.isfinite(got[2, :tb]).any()
        assert np.isinf(got[4, :tb]).all()


def _check_grammar(results, tok):
    tb = tok.timestamp_begin
    for r in results:
        assert r.tokens and tb <= r.tokens[0] <= tb + 50
        ts = [t for t in r.tokens if t >= tb]
        assert ts == sorted(ts)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_int8=True),
    dict(kv_int4=True),
    dict(prompt=[5, 6, 7]),
    None,  # decode(params, cfg, mel): the default DecodingOptions()
], ids=["float", "int8", "int4", "prompt", "default-options"])
def test_greedy_timestamps_match_jax(params, jax_params, mel, tok, jtok, kw):
    if kw is None:
        ref = jax_decode(jax_params, JCFG, jnp.asarray(mel))
        ours = decode(params, CFG, mel)
    else:
        opts = dict(language="en", sample_len=SAMPLE_LEN, **kw)
        ref = jax_decode(jax_params, JCFG, jnp.asarray(mel), JaxOptions(**opts),
                         tokenizer=jtok)
        ours = decode(params, CFG, mel, DecodingOptions(**opts), tokenizer=tok)
    assert len(ours) == len(ref) == len(mel)
    for a, b in zip(ours, ref):
        assert a.tokens == b.tokens
        assert a.text == b.text and a.language == b.language
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=LOGPROB_ATOL)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob,
                                                 abs=NO_SPEECH_ATOL)
    _check_grammar(ours, tok)


def _jax_candidates(jax_params, mel, jtok, n):
    """JAX's own best-of candidates: the greedy program on the n-fold tiled
    batch at temperature 0.8, as ``decode`` calls it."""
    opts = JaxOptions(language="en", without_timestamps=True,
                      sample_len=SAMPLE_LEN, temperature=0.8, best_of=n)
    prefix = jax_decoding.initial_tokens(jtok, opts)
    feats = jax_decoding._encode_jit(jax_params, JCFG, jnp.asarray(mel),
                                     dtype=jnp.float32)
    feats = jnp.repeat(feats, n, axis=0)
    prefix_tokens = jnp.repeat(jnp.asarray([prefix], jnp.int32), len(mel) * n,
                               axis=0)
    out = jax_decoding._greedy_decode_jit(
        jax_params, JCFG, feats, prefix_tokens,
        jnp.asarray(jax_decoding.build_suppress_mask(jtok, opts, JCFG.n_vocab)),
        jnp.asarray(jax_decoding.build_blank_mask(jtok, JCFG.n_vocab)),
        jtok.eot, len(prefix), SAMPLE_LEN, 0.8, jax.random.PRNGKey(0))
    return opts, len(prefix), [np.array(x) for x in out]


@pytest.mark.parametrize("length_penalty", [None, 1.0])
def test_rank_candidates_picks_jax_row(jax_params, mel, tok, jtok,
                                       length_penalty):
    n = 3
    opts, n_prefix, (tokens, sums, sot_logits) = _jax_candidates(
        jax_params, mel, jtok, n)
    # ties: input 0's candidate 2 copies candidate 1, and input 1's three
    # candidates are one candidate three times
    tokens[2], sums[2] = tokens[1], sums[1]
    tokens[3:6], sums[3:6] = tokens[3], sums[3]
    opts = replace(opts, length_penalty=length_penalty)

    real = jax_decoding.aot_call

    def crafted(fn, *args, **kwargs):
        if fn is jax_decoding._greedy_decode_jit:
            return tokens, sums, sot_logits
        return real(fn, *args, **kwargs)

    with mock.patch.object(jax_decoding, "aot_call", side_effect=crafted):
        ref = jax_decode(jax_params, JCFG, jnp.asarray(mel), opts, tokenizer=jtok)
    keep = rank_candidates(tokens, sums, n, n_prefix, tok.eot, length_penalty)
    assert len(keep) == len(mel) and keep[1] == 3  # the first of a tie
    for row, r in zip(keep, ref):
        seq = tokens[row, n_prefix:]
        end = int(np.argmax(seq == tok.eot)) if (seq == tok.eot).any() else len(seq)
        assert seq[:end].tolist() == r.tokens
        assert float(sums[row]) / (end + 1) == pytest.approx(r.avg_logprob)


def test_best_of_keeps_each_inputs_best(params, mel, tok):
    """best_of=3 at temperature 0.5: one result an input, each the
    highest-scoring of that input's own three candidates."""
    seen = {}
    real = port_decoding._greedy_decode

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen["tokens"], seen["sums"] = out[0].numpy(), out[1].numpy()
        seen["batch"] = args[2].shape[0]
        return out

    opts = DecodingOptions(language="en", sample_len=SAMPLE_LEN,
                           temperature=0.5, best_of=3, seed=3)
    with mock.patch.object(port_decoding, "_greedy_decode", side_effect=spy):
        results = decode(params, CFG, mel, opts, tokenizer=tok)
    assert len(results) == len(mel) and seen["batch"] == 3 * len(mel)
    n_prefix = seen["tokens"].shape[1] - SAMPLE_LEN
    for b, r in enumerate(results):
        scores = []
        for row in range(3 * b, 3 * b + 3):
            seq = seen["tokens"][row, n_prefix:]
            end = int(np.argmax(seq == tok.eot)) if (seq == tok.eot).any() else len(seq)
            scores.append((sequence_score(float(seen["sums"][row]), end, None),
                           seq[:end].tolist()))
        best = max(scores, key=lambda s: s[0])
        assert r.tokens == best[1]
        assert r.temperature == 0.5 and np.isfinite(r.avg_logprob)
    _check_grammar(results, tok)
