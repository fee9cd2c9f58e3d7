"""PyTorch port: speculative decoding against the JAX package, on the CPU.

Same weights (numpy bridge), same seeded mel, f32: the port's
``decode_step_block`` gives JAX's logits, hidden states and cache writes
(only the first ``write_len`` entries land, at the first entry's position
onwards; the rest of the cache is untouched); ``_ngram_drafts`` gives JAX's
drafts; ``speculative_decode`` with an unrelated draft, a self-draft and
n-gram lookup, at K = 1, 3, 4 and 6, over the float, int8 and int4 cross
caches, gives JAX's tokens, texts, ``avg_logprob`` and ``no_speech_prob``,
equal to the port's own ``decode()``, and JAX's ``SpeculativeStats``
exactly. Rows run to the sample-length budget at the context's edge keep
every cache write inside the buffer.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode.speculative import _ngram_drafts as jax_ngram
from whisper_ipa_tpu.decode.speculative import speculative_decode as jax_spec
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.whisper import decode_step as jax_decode_step
from whisper_ipa_tpu.models.whisper import decode_step_block as jax_block
from whisper_ipa_tpu.models.whisper import encode as jax_encode
from whisper_ipa_tpu.models.whisper import init_cache as jax_init_cache
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import DecodingOptions, decode, speculative_decode
from whisper_ipa_torch.decode import speculative as spec_module
from whisper_ipa_torch.decode.speculative import _ngram_drafts
from whisper_ipa_torch.models import (
    decode_step,
    decode_step_block,
    init_cache,
    params_from_numpy,
)
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
N_MEL_FRAMES = CFG.n_audio_ctx * 2
EOT = 50257


def _bridge(jparams):
    return params_from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten_params(jparams).items()})


@pytest.fixture(scope="module")
def models():
    """JAX target (seed 0) and unrelated draft (seed 7), and the port's
    copies of both."""
    jt, jd = jax_init_params(JCFG, seed=0), jax_init_params(JCFG, seed=7)
    return dict(jt=jt, jd=jd, t=_bridge(jt), d=_bridge(jd))


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(3)
    return rng.standard_normal((3, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)


@pytest.fixture(scope="module")
def toks():
    return (get_tokenizer(multilingual=True, language="en"),
            jax_get_tokenizer(multilingual=True, language="en"))


# -- decode_step_block --------------------------------------------------------

@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_step_block_matches_jax(models, kv_int8):
    """A tree block: 3 re-fed tokens, then nodes at depths 1, 1, 2 (two
    siblings share a position), per-row frontiers, a (B, S, S) mask, and
    only the re-fed entries written."""
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)
    feats = np.array(jax_encode(models["jt"], JCFG, jnp.asarray(mel)))
    n_ctx = 16
    prefix = np.array([[50258, 50259, 50359, 50363, 300, 301]] * 2)
    jcache = jax_init_cache(models["jt"], JCFG, jnp.asarray(feats), max_len=n_ctx,
                            cross_kv_int8=kv_int8)
    _, jcache = jax_decode_step(models["jt"], JCFG, jnp.asarray(prefix), jcache, 0)
    cache = init_cache(models["t"], CFG, torch.from_numpy(feats), max_len=n_ctx,
                       cross_kv_int8=kv_int8)
    with torch.no_grad():
        decode_step(models["t"], CFG, torch.from_numpy(prefix), cache, 0)

    # row 0: lens 6 (re-feed 3..5); row 1: lens 5 (re-feed 2..4)
    lens = np.array([6, 5])
    R, depth, anc = 3, np.array([1, 1, 2]), np.array(
        [[1, 0, 0], [0, 1, 0], [1, 0, 1]], bool)
    start = lens - R
    refeed_pos = start[:, None] + np.arange(R)
    pos = np.concatenate([refeed_pos, lens[:, None] + depth[None] - 1], axis=1)
    tokens = np.concatenate(
        [np.take_along_axis(np.tile(prefix, 1), refeed_pos, 1),
         rng.integers(0, 1000, (2, 3))], axis=1)
    allowed = np.zeros((2, 6, 6), bool)
    allowed[:, :R, :R] = refeed_pos[:, None, :] <= refeed_pos[:, :, None]
    allowed[:, R:, :R] = True
    allowed[:, R:, R:] = anc
    mask = np.where(allowed, 0.0, -np.inf).astype(np.float32)

    jl, jcache, jh = jax_block(models["jt"], JCFG, jnp.asarray(tokens), jcache,
                               jnp.asarray(pos), jnp.asarray(start),
                               jnp.asarray(mask), write_len=R)
    before = cache.self_k.clone()
    with torch.no_grad():
        logits, cache, hidden = decode_step_block(
            models["t"], CFG, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(start),
            torch.from_numpy(mask), write_len=R)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    for b in range(2):
        rows = slice(start[b], start[b] + R)
        np.testing.assert_allclose(cache.self_k[:, b, rows].numpy(),
                                   np.asarray(jcache.self_k)[:, b, rows],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(cache.self_v[:, b, rows].numpy(),
                                   np.asarray(jcache.self_v)[:, b, rows],
                                   rtol=0, atol=1e-5)
        # the read-only draft nodes left every other row as it was
        untouched = [i for i in range(n_ctx) if not start[b] <= i < start[b] + R]
        assert torch.equal(cache.self_k[:, b, untouched],
                           before[:, b, untouched])


# -- n-gram drafts ------------------------------------------------------------

def test_ngram_known_answers():
    """The JAX tests' two buffers: bigram continuation, no match, and the
    trigram winning over a more recent bigram."""
    buf = torch.tensor([[4, 5, 6, 7, 8, 9, 5, 6, 0, 0],
                        [1, 2, 9, 9, 9, 9, 2, 3, 0, 0]])
    d = _ngram_drafts(buf, torch.tensor([8, 8]), 3)
    assert d.tolist() == [[7, 8, 9], [3, 3, 3]]
    buf = torch.tensor([[1, 5, 6, 7, 2, 5, 6, 8, 1, 5, 6, 0],
                        [3, 5, 6, 4, 2, 2, 2, 2, 9, 5, 6, 0]])
    d = _ngram_drafts(buf, torch.tensor([11, 11]), 2)
    assert d.tolist() == [[7, 2], [4, 2]]


@pytest.mark.parametrize("K", [1, 4, 7])
def test_ngram_drafts_match_jax(K):
    """Seeded buffers over a 5-token vocabulary (many repeats) and seeded
    lengths, the short ones included."""
    rng = np.random.default_rng(K)
    buf = rng.integers(0, 5, (64, 24)).astype(np.int32)
    lens = rng.integers(1, 24, 64).astype(np.int32)
    want = np.asarray(jax_ngram(jnp.asarray(buf), jnp.asarray(lens), K))
    got = _ngram_drafts(torch.from_numpy(buf).long(), torch.from_numpy(lens).long(), K)
    assert got.tolist() == want.tolist()


# -- speculative_decode -------------------------------------------------------

def _spec_pair(models, mel, toks, source, K, **opts):
    """(port results, port stats, JAX results, JAX stats) for one draft
    source: 'draft' (unrelated), 'self' or 'ngram'."""
    tok, jtok = toks
    kw = dict(language="en", without_timestamps=True, **opts)
    pd, jd = {"draft": (models["d"], models["jd"]),
              "self": (models["t"], models["jt"]),
              "ngram": (None, None)}[source]
    ours = speculative_decode(models["t"], CFG, pd, CFG if pd is not None else None,
                              mel, DecodingOptions(**kw), draft_k=K,
                              tokenizer=tok, return_stats=True)
    theirs = jax_spec(models["jt"], JCFG, jd, JCFG if jd is not None else None,
                      jnp.asarray(mel), JaxOptions(**kw), draft_k=K,
                      tokenizer=jtok, return_stats=True)
    return (*ours, *theirs)


def _assert_results(got, want):
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    for a, b in zip(got, want):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-6)
        assert a.compression_ratio == b.compression_ratio


@pytest.mark.parametrize("source,K,cache", [
    ("self", 3, "float"),
    ("draft", 1, "float"),
    ("draft", 6, "float"),
    ("draft", 3, "int8"),
    ("ngram", 4, "int8"),
    ("self", 3, "int4"),
    ("ngram", 3, "int4"),
])
def test_speculative_matches_jax_and_decode(models, mel, toks, source, K, cache):
    opts = dict(sample_len=12, kv_int8=cache == "int8", kv_int4=cache == "int4")
    got, stats, want, jstats = _spec_pair(models, mel, toks, source, K, **opts)
    _assert_results(got, want)
    assert (stats.rounds, stats.emitted_tokens, stats.draft_k, stats.batch) == (
        jstats.rounds, jstats.emitted_tokens, jstats.draft_k, jstats.batch)
    plain = decode(models["t"], CFG, mel, DecodingOptions(
        language="en", without_timestamps=True, **opts), tokenizer=toks[0])
    _assert_results(got, plain)
    if source == "self" and cache == "float":
        # the target drafting for itself accepts all (a quantized target
        # cache differs from the draft's float one)
        assert stats.rounds <= -(-12 // (K + 1))


def test_rows_run_to_the_budget_stay_in_the_buffer(models, mel, toks,
                                                   monkeypatch):
    """EOT suppressed: every row runs to sample_len, which the context cut
    (48 - 4 prefix - K - 1 = 37) sets. Every K/V write of the draft's K + 1
    steps and of the target's blocks, finished rows included, lands below
    the buffer's end."""
    K, highest, source = 6, [], "draft"
    for name in ("decode_step_multipos", "decode_step_multipos_hidden"):
        inner = getattr(spec_module, name)

        def spy(params, cfg, tokens, cache, pos, dtype=torch.float32, tp=None,
                inner=inner):
            highest.append((int(pos.max()) + tokens.shape[1] - 1,
                            cache.self_k.shape[2]))
            return inner(params, cfg, tokens, cache, pos, dtype=dtype, tp=tp)

        monkeypatch.setattr(spec_module, name, spy)
    opts = dict(sample_len=40, suppress_tokens=[-1, EOT])
    got, stats, want, jstats = _spec_pair(models, mel[:2], toks, source, K, **opts)
    _assert_results(got, want)
    assert stats.emitted_tokens == jstats.emitted_tokens == 2 * 37
    assert stats.rounds == jstats.rounds
    assert all(len(r.tokens) == 37 for r in got)
    assert max(h for h, _ in highest) < highest[0][1] == 4 + 37 + K + 1


@pytest.mark.parametrize("change,message", [
    (dict(temperature=0.5), "temperature"),
    (dict(without_timestamps=False), "without_timestamps"),
    (dict(beam_size=2), "beam_size"),
    (dict(best_of=2), "best_of"),
    ("medusa", "excludes a draft model"),
    ("vocab", "share the tokenizer"),
    ("mels", "draft_mel is required"),
])
def test_speculative_rejections(models, mel, change, message):
    """The reference's ValueErrors, raised before any decoding."""
    opts = DecodingOptions(language="en", without_timestamps=True)
    draft, draft_cfg, kw = models["d"], CFG, {}
    if isinstance(change, dict):
        opts = replace(opts, **change)
    elif change == "medusa":
        kw = dict(medusa_params={"heads": []})
    elif change == "vocab":
        draft_cfg = replace(CFG, n_vocab=CFG.n_vocab + 1)
    else:
        draft_cfg = replace(CFG, n_mels=128)
    with pytest.raises(ValueError, match=message):
        speculative_decode(models["t"], CFG, draft, draft_cfg, mel, opts, **kw)
