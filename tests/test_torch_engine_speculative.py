"""PyTorch port: the in-flight engine's speculative modes against the JAX
package.

Same weights (numpy bridge), same inputs, f32 on the CPU. The speculative
device functions (``_join_step_hidden``, ``_join_step_tree``,
``_spec_chunk``, ``_spec_chunk_model``, ``_spec_chunk_medusa``,
``_spec_chunk_medusa_tree``) are held against the JAX package's from one
cache state through a join, chunks, a re-join and a run to the budget:
integers equal, hidden states and K/V within 1e-5. The engine in each mode
(n-gram, a draft model, Medusa chain and tree) is held against the JAX
package's ``decode()`` on each window's log-mel (the port's), in the JAX
package's own cases (``tests/test_serve_continuous.py``) at its shapes:
the speculative engine's tokens are the greedy engine's. The random model
answers most inputs alike, so the cases use seeded tones whose references
differ, as ``tests/test_torch_serve_continuous.py`` does.
"""

import threading
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_ipa_tpu.models.whisper as jax_whisper
import whisper_ipa_tpu.serve_continuous as jax_sc
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode import decode as jax_decode
from whisper_ipa_tpu.decode.medusa_tree import DEFAULT_TREE as JAX_TREE
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.serve_continuous import ContinuousBatcher as JaxEngine
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
import whisper_ipa_torch.serve_continuous as sc
from whisper_ipa_torch.audio import N_SAMPLES, pad_or_trim
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode.medusa_tree import DEFAULT_TREE
from whisper_ipa_torch.models import (
    DecoderCache,
    init_cache,
    medusa_from_numpy,
    params_from_numpy,
)
from whisper_ipa_torch.ops import log_mel_spectrogram
from whisper_ipa_torch.serve_continuous import ContinuousBatcher
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

# full 30 s windows, tiny transformer widths (the JAX tests' shapes)
NARROW = dict(n_audio_state=32, n_audio_head=2, n_audio_layer=1,
              n_text_state=32, n_text_head=2, n_text_layer=1, n_text_ctx=24)
CFG = replace(CONFIGS["test-tiny"], **NARROW)
JCFG = replace(JAX_CONFIGS["test-tiny"], **NARROW)
MAX_NEW = 8
K = 3  # draft tokens a round (n-gram, draft model, Medusa chain)


def _bridge(jax_tree):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_tree).items()}
    return params_from_numpy(flat)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    return _bridge(jax_params)


def _biased(jax_tree):
    """A model with its final layer norm's bias pulled toward token 1000's
    embedding: its greedy output is that token often, not always, so drafts
    are accepted several at a time and rejected in turn."""
    emb = np.asarray(jax_tree["decoder"]["token_embedding"])
    u = emb[1000] / np.linalg.norm(emb[1000])
    dec = dict(jax_tree["decoder"])
    dec["ln"] = dict(dec["ln"], b=jnp.asarray(np.asarray(dec["ln"]["b"]) + 5 * u))
    return dict(jax_tree, decoder=dec)


@pytest.fixture(scope="module")
def jax_draft():
    return jax_init_params(JCFG, seed=9)  # an unrelated draft model


@pytest.fixture(scope="module")
def draft(jax_draft):
    return _bridge(jax_draft)


def _heads(n: int, seed: int):
    """Seeded Medusa heads with a nonzero residual (fresh heads have
    w2 = 0 and propose the base head's token): JAX's and the port's."""
    rng = np.random.default_rng(seed)
    d = CFG.n_text_state
    heads = [{"w1": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
              "b1": 0.1 * rng.standard_normal(d).astype(np.float32),
              "w2": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
              "b2": 0.1 * rng.standard_normal(d).astype(np.float32)}
             for _ in range(n)]
    jax_heads = {"heads": [{k: jnp.asarray(v) for k, v in h.items()}
                           for h in heads]}
    return jax_heads, medusa_from_numpy({"heads": heads})


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def jtok():
    return jax_get_tokenizer(multilingual=True, language="en")


def _mel(audio) -> np.ndarray:
    """The port's log-mel of one 30 s window (the engine's own)."""
    return log_mel_spectrogram(
        torch.from_numpy(pad_or_trim(np.asarray(audio, np.float32))),
        CFG.n_mels).numpy()


_REFERENCE = {}


@pytest.fixture(scope="module")
def reference(jax_params, jtok):
    """Standalone JAX greedy decode of one window: its tokens."""

    def tokens(audio, kv_int8=False, max_new=MAX_NEW):
        audio = np.asarray(audio, np.float32)
        key = (audio.tobytes(), kv_int8, max_new)
        if key not in _REFERENCE:
            res = jax_decode(
                jax_params, JCFG, jnp.asarray(_mel(audio))[None],
                JaxOptions(language="en", without_timestamps=True,
                           sample_len=max_new, kv_int8=kv_int8),
                tokenizer=jtok,
            )
            _REFERENCE[key] = res[0].tokens
        return _REFERENCE[key]

    def windows(audio, **kw):
        out = []
        for s in range(0, max(len(audio), 1), N_SAMPLES):
            out.extend(tokens(audio[s:s + N_SAMPLES], **kw))
        return out

    tokens.windows = windows
    return tokens


def _audio(seed: int, n: int = None) -> np.ndarray:
    """A seeded tone in noise, 1-4 s unless n samples are asked for."""
    rng = np.random.default_rng(seed)
    n = n or 16000 * (1 + seed % 4)
    freq = rng.uniform(100, 4000)
    tone = rng.uniform(0.05, 0.5) * np.sin(2 * np.pi * freq * np.arange(n) / 16000)
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


# seeds whose windows the reference decodes to eight different sequences
DISTINCT = [0, 1, 7, 9, 10, 17, 25, 31]


# -- the device functions against JAX's, from one cache state -------------

def _to_jax_cache(cache: DecoderCache):
    def conv(t):
        return None if t is None else jnp.asarray(t.numpy())

    return jax_whisper.DecoderCache(*(conv(t) for t in cache))


def _i32(t):
    return jnp.asarray(np.asarray(t), jnp.int32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=1e-5, rtol=0,
                               err_msg=what)


def _same_cache(cache, jcache, what):
    for name, got, want in (("self_k", cache.self_k, jcache.self_k),
                            ("self_v", cache.self_v, jcache.self_v)):
        _close(got.numpy(), want, f"{what} {name}")


class _Pair:
    """One engine state in both packages, driven through the same joins and
    chunks; every stage is compared."""

    def __init__(self, mode, params, jax_params, draft, jax_draft, tok,
                 kv_int8):
        self.mode = mode
        self.params, self.jparams = params, jax_params
        kw = {}
        if mode.startswith("model"):
            self.dparams, self.jdparams = ((params, jax_params)
                                           if mode == "model self" else
                                           (draft, jax_draft))
            kw = dict(draft_k=K, draft_params=self.dparams, draft_cfg=CFG)
        elif mode == "ngram":
            kw = dict(draft_k=K)
        else:
            n_heads = 4 if mode == "tree" else K
            self.jheads, self.heads = _heads(n_heads, seed=3)
            kw = dict(medusa_params=self.heads)
            if mode == "tree":
                kw["medusa_tree"] = DEFAULT_TREE
        eng = ContinuousBatcher(params, CFG, device="cpu", slots=3,
                                max_new_tokens=7, tokenizer=tok, **kw)
        eng.close()
        self.eng = eng
        self.B, self.P = 3, eng.n_prefix
        rng = np.random.default_rng(5)

        def cache_of(p):
            feats = torch.from_numpy(rng.standard_normal(
                (self.B, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
            c = init_cache(p, CFG, feats, max_len=eng._cache_len,
                           cross_kv_int8=kv_int8)
            return c, _to_jax_cache(c)

        self.cache, self.jcache = cache_of(params)
        self.dcache = self.jdcache = None
        if mode.startswith("model"):
            self.dcache, self.jdcache = cache_of(self.dparams)
        self.hidden = torch.zeros((self.B, CFG.n_text_state))
        self.jhidden = jnp.zeros((self.B, CFG.n_text_state), jnp.float32)
        self.last_tok = torch.full((self.B,), eng.prefix[-1])
        self.lens = torch.full((self.B,), self.P)
        self.finished = torch.zeros(self.B, dtype=torch.bool)
        self.history = [[] for _ in range(self.B)]
        self.masks = (eng.suppress, eng.blank)
        self.jmasks = tuple(jnp.asarray(m.numpy()) for m in self.masks)
        self.vs = []

    def _jstate(self):
        return (_i32(self.last_tok), _i32(self.lens),
                jnp.asarray(self.finished.numpy()))

    def join(self, joiners):
        """The engine's join block (``ContinuousBatcher._join``) from the
        host history."""
        eng, B, P = self.eng, self.B, self.P
        for b in joiners:
            self.history[b] = []
        rows = np.tile(np.asarray(eng.prefix), (B, 1))
        pos = np.maximum(self.lens.numpy() - P, 0)
        for b in range(B):
            if b in joiners:
                pos[b] = 0
                continue
            tail = (list(eng.prefix) + self.history[b])[pos[b]:pos[b] + P]
            rows[b, :len(tail)] = tail
        if self.mode == "tree":
            W = eng._tree_join_width
            trows = np.full((B, W), eng.eot)
            starts, lens_eff = np.zeros(B, np.int64), np.zeros(B, np.int64)
            for b in range(B):
                hist = list(eng.prefix) + self.history[b]
                lens_eff[b], starts[b] = len(hist), max(len(hist) - W, 0)
                seg = hist[starts[b]:starts[b] + W]
                trows[b, :len(seg)] = seg
            args = (trows, starts, lens_eff)
            self.cache, self.hidden = sc._join_step_tree(
                self.params, CFG, self.cache,
                *(torch.from_numpy(a) for a in args))
            self.jcache, self.jhidden = jax_sc._join_step_tree(
                self.jparams, JCFG, self.jcache, *(_i32(a) for a in args))
        elif self.mode == "medusa":
            self.cache, self.hidden = sc._join_step_hidden(
                self.params, CFG, self.cache, torch.from_numpy(rows),
                torch.from_numpy(pos))
            self.jcache, self.jhidden = jax_sc._join_step_hidden(
                self.jparams, JCFG, self.jcache, _i32(rows), _i32(pos))
        else:
            self.cache = sc._join_step(self.params, CFG, self.cache,
                                       torch.from_numpy(rows),
                                       torch.from_numpy(pos))
            self.jcache = jax_sc._join_step(self.jparams, JCFG, self.jcache,
                                            _i32(rows), _i32(pos))
        if self.dcache is not None:
            self.dcache = sc._join_step(self.dparams, CFG, self.dcache,
                                        torch.from_numpy(rows),
                                        torch.from_numpy(pos))
            self.jdcache = jax_sc._join_step(self.jdparams, JCFG, self.jdcache,
                                             _i32(rows), _i32(pos))
        for b in joiners:
            self.lens[b] = P
            self.last_tok[b] = eng.prefix[-1]
            self.finished[b] = False
        self._compare("join")

    def _tokens_buf(self):
        eng = self.eng
        buf = np.full((self.B, eng._cache_len), eng.eot)
        for b in range(self.B):
            hist = list(eng.prefix) + self.history[b]
            buf[b, :len(hist)] = hist
        return buf

    def chunk(self, rounds: int):
        eng, P, mx = self.eng, self.P, self.eng.max_new
        common = (self.last_tok, self.lens, self.finished, *self.masks,
                  eng.eot, rounds)
        jcommon = (*self._jstate(), *self.jmasks, eng.eot, rounds)
        if self.mode == "ngram":
            buf = self._tokens_buf()
            (self.cache, self.last_tok, self.lens, self.finished, emits,
             vs) = sc._spec_chunk(self.params, CFG, self.cache,
                                  torch.from_numpy(buf), *common, K, P, mx)
            (self.jcache, *jstate, jemits, jvs) = jax_sc._spec_chunk(
                self.jparams, JCFG, self.jcache, _i32(buf), *jcommon, K, P,
                mx)
        elif self.mode.startswith("model"):
            (self.cache, self.dcache, self.last_tok, self.lens, self.finished,
             emits, vs) = sc._spec_chunk_model(
                self.params, self.dparams, CFG, CFG, self.cache, self.dcache,
                *common, K, P, mx)
            (self.jcache, self.jdcache, *jstate, jemits,
             jvs) = jax_sc._spec_chunk_model(
                self.jparams, self.jdparams, JCFG, JCFG, self.jcache,
                self.jdcache, *jcommon, K, P, mx)
        elif self.mode == "medusa":
            (self.cache, self.hidden, self.last_tok, self.lens, self.finished,
             emits, vs) = sc._spec_chunk_medusa(
                self.params, self.heads, CFG, self.cache, self.hidden,
                *common, P, mx)
            (self.jcache, self.jhidden, *jstate, jemits,
             jvs) = jax_sc._spec_chunk_medusa(
                self.jparams, self.jheads, JCFG, self.jcache, self.jhidden,
                *jcommon, K, P, mx)
        else:
            buf = self._tokens_buf()
            (self.cache, self.hidden, self.last_tok, self.lens, self.finished,
             emits, vs) = sc._spec_chunk_medusa_tree(
                self.params, self.heads, CFG, self.cache,
                torch.from_numpy(buf), self.hidden, *common, P, mx,
                tree=DEFAULT_TREE)
            (self.jcache, self.jhidden, *jstate, jemits,
             jvs) = jax_sc._spec_chunk_medusa_tree(
                self.jparams, self.jheads, JCFG, self.jcache, _i32(buf),
                self.jhidden, *jcommon, P, mx, tree=JAX_TREE)
        np.testing.assert_array_equal(emits.numpy(), np.asarray(jemits))
        np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))
        for got, want in zip((self.last_tok, self.lens, self.finished), jstate):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for r in range(rounds):
            for b in range(self.B):
                self.history[b] += [int(t) for t in emits[r, b, :vs[r, b]]
                                    if t != eng.eot]
        self.vs.append(vs)
        self._compare("chunk")
        return emits, vs

    def _compare(self, what):
        _same_cache(self.cache, self.jcache, what)
        if self.dcache is not None:
            _same_cache(self.dcache, self.jdcache, f"{what} draft")
        _close(self.hidden.numpy(), self.jhidden, f"{what} hidden_frontier")
        for b in range(self.B):  # the host history is the device lens
            assert len(self.history[b]) + self.P >= int(self.lens[b])


MODES = ["ngram", "model unrelated", "model self", "medusa", "tree"]


@pytest.mark.parametrize("weights,kv_int8", [("random", False),
                                             ("random", True),
                                             ("biased", False)])
@pytest.mark.parametrize("mode", MODES)
def test_spec_chunks_match_jax(params, jax_params, draft, jax_draft, tok,
                               mode, weights, kv_int8):
    """From one cache state both packages run: a join of every slot, a
    2-round chunk, a re-join of slot 1 while the others re-feed (the tree's
    W-wide join, the Medusa join's frontier hidden, the draft's join on the
    same rows), slot 2 finished, then 2-round chunks until every slot has
    halted, the last ones at the 7-token budget. emits, vs, lens, last_tok
    and finished are equal at every stage; hidden_frontier and the self K/V
    (the draft's too) within 1e-5. The random models accept few drafts; the
    biased ones (``_biased``) accept runs of them in every mode."""
    if weights == "biased":
        jax_params, jax_draft = _biased(jax_params), _biased(jax_draft)
        params, draft = _bridge(jax_params), _bridge(jax_draft)
    pair = _Pair(mode, params, jax_params, draft, jax_draft, tok, kv_int8)
    P, max_new = pair.P, pair.eng.max_new
    pair.join([0, 1, 2])
    pair.chunk(2)
    pair.join([1])
    pair.finished[2] = True
    for _ in range(8):
        pair.chunk(2)
        if bool((pair.finished | (pair.lens - P >= max_new)).all()):
            break
    else:
        pytest.fail("the slots did not halt")
    vs = torch.cat(pair.vs)
    assert int(vs.sum()) > 0
    if weights == "biased":
        assert int(vs.max()) >= 2  # a round emitted accepted drafts
    elif mode == "model self":
        # the draft is the target: every round accepts all K drafts, so the
        # second round of a slot is cut at the budget, 7 = 4 + 3
        assert (vs[:, :2] == K + 1).any() and (vs[:, :2] == max_new - K - 1).any()
        assert bool((pair.lens[:2] - P == max_new).all())


@pytest.mark.parametrize("kv_int8", [False, True])
def test_join_steps_match_jax(params, jax_params, tok, kv_int8):
    """``_join_step_hidden`` and ``_join_step_tree`` alone on a random
    running batch: per-slot positions up to the last row of the cache, a
    tree join whose slots start at 0 (lens below W) and past it; the
    frontier hidden and the written K/V within 1e-5 of JAX's, the rows
    outside the block untouched."""
    rng = np.random.default_rng(11)
    B, n_ctx, P, W = 4, 14, 4, 6
    feats = torch.from_numpy(rng.standard_normal(
        (B, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    base = init_cache(params, CFG, feats, max_len=n_ctx, cross_kv_int8=kv_int8)
    for buf in (base.self_k, base.self_v):
        buf.copy_(torch.from_numpy(rng.standard_normal(buf.shape).astype(
            np.float32)))
    tokens = rng.integers(0, CFG.n_vocab, (B, W))

    def clone(c):
        return DecoderCache(*(None if t is None else t.clone() for t in c))

    pos = np.array([0, 3, 7, n_ctx - P])
    cache, hidden = sc._join_step_hidden(params, CFG, clone(base),
                                         torch.from_numpy(tokens[:, :P]),
                                         torch.from_numpy(pos))
    jcache, jhidden = jax_sc._join_step_hidden(
        jax_params, JCFG, _to_jax_cache(base), _i32(tokens[:, :P]), _i32(pos))
    _close(hidden.numpy(), jhidden, "hidden")
    _same_cache(cache, jcache, "join hidden")

    lens_eff = np.array([P, 5, 9, n_ctx])
    start = np.maximum(lens_eff - W, 0)
    cache, hidden = sc._join_step_tree(
        params, CFG, clone(base), torch.from_numpy(tokens),
        torch.from_numpy(start), torch.from_numpy(lens_eff))
    jcache, jhidden = jax_sc._join_step_tree(
        jax_params, JCFG, _to_jax_cache(base), _i32(tokens), _i32(start),
        _i32(lens_eff))
    _close(hidden.numpy(), jhidden, "tree hidden")
    _same_cache(cache, jcache, "join tree")
    changed = (cache.self_k != base.self_k).any(dim=(0, 3)).numpy()
    for b in range(B):
        assert set(np.nonzero(changed[b])[0]) <= set(range(start[b],
                                                           start[b] + W))


# -- the engine against JAX's decode() -------------------------------------

def _engine(params, tok, mode, **kw):
    """An engine of 2 slots, 2 rounds a sync, in one speculative mode."""
    draft = kw.pop("draft", None)
    if mode == "ngram":
        extra = dict(draft_k=K)
    elif mode == "model":
        extra = dict(draft_k=K, draft_params=draft, draft_cfg=CFG)
    elif mode == "medusa":
        extra = dict(medusa_params=_heads(K, seed=1)[1])
    elif mode == "tree":
        # DEFAULT_TREE is 4 deep: the tree-mode join is K + 2 = 6 wide,
        # wider than the 4-token prefix
        extra = dict(medusa_params=_heads(4, seed=2)[1],
                     medusa_tree=DEFAULT_TREE)
    return ContinuousBatcher(params, CFG, device="cpu", slots=2,
                             max_new_tokens=kw.pop("max_new", MAX_NEW),
                             steps_per_sync=kw.pop("steps_per_sync", 2),
                             language="en", tokenizer=tok, **extra, **kw)


@pytest.fixture(scope="module")
def spec_engine(params, tok):
    """The n-gram engine (draft_k 3) shared by the JAX package's cases."""
    eng = _engine(params, tok, "ngram")
    yield eng
    eng.close()
    assert not eng._thread.is_alive()


def test_ngram_engine_matches_plain_greedy(spec_engine, reference):
    """draft_k > 0 changes the schedule (1 to K + 1 tokens a round a slot),
    never the tokens. A chunk runs every round asked for, as the
    reference's fixed scan: spec_rounds counts 2 a chunk, 1 a fast chunk
    after a join."""
    audio = _audio(DISTINCT[0])
    before = spec_engine.stats()
    out = spec_engine.transcribe(audio, timeout=300)
    st = spec_engine.stats()
    d = {k: st[k] - before[k] for k in ("spec_rounds", "spec_emitted",
                                        "spec_slot_rounds", "chunks",
                                        "fast_chunks")}
    assert out["tokens"] == reference(audio)
    assert d["spec_rounds"] == 2 * d["chunks"] - d["fast_chunks"] > 0
    # one slot active: a round emits 1 to K + 1 tokens, EOT not counted
    assert d["spec_slot_rounds"] <= d["spec_rounds"]
    assert (len(out["tokens"]) == d["spec_emitted"]
            <= (K + 1) * d["spec_slot_rounds"])


def test_ngram_engine_join_and_streaming(spec_engine, reference):
    a1, a2 = _audio(DISTINCT[1]), _audio(DISTINCT[2])
    seen = []
    f1 = spec_engine.submit(a1, on_token=seen.append)
    time.sleep(0.02)  # a2 joins the running batch
    f2 = spec_engine.submit(a2)
    r1, r2 = f1.result(timeout=300), f2.result(timeout=300)
    assert r1["tokens"] == reference(a1)
    assert r2["tokens"] == reference(a2)
    assert [s["token"] for s in seen] == r1["tokens"]


def test_ngram_engine_long_audio(spec_engine, reference):
    audio = _audio(8, N_SAMPLES + 16000)
    out = spec_engine.transcribe(audio, timeout=300)
    assert out["n_windows"] == 2
    assert out["tokens"] == reference.windows(audio)


def test_model_draft_engine_matches_plain_greedy(params, draft, tok, reference):
    """An unrelated random draft (the floor of acceptance) still gives the
    greedy tokens, with a request joining the running batch."""
    eng = _engine(params, tok, "model", draft=draft)
    try:
        a1, a2 = _audio(DISTINCT[3]), _audio(DISTINCT[4])
        f1 = eng.submit(a1)
        time.sleep(0.02)
        f2 = eng.submit(a2)
        assert f1.result(timeout=300)["tokens"] == reference(a1)
        assert f2.result(timeout=300)["tokens"] == reference(a2)
        assert eng.stats()["spec_rounds"] > 0
    finally:
        eng.close()


def test_model_draft_engine_self_draft_accepts_fully(params, tok, reference):
    """Draft == target: every draft verifies, so a round advances K + 1
    tokens and the 8-token budget clears within two 2-round chunks."""
    eng = _engine(params, tok, "model", draft=params)
    try:
        audio = _audio(DISTINCT[5])
        out = eng.transcribe(audio, timeout=300)
        st = eng.stats()
    finally:
        eng.close()
    assert out["tokens"] == reference(audio)
    assert st["spec_rounds"] > 0 and st["chunks"] <= 2


def test_medusa_engine_matches_plain_greedy(params, tok, reference):
    """Medusa chain: draft_k is the head count; a mid-flight joiner's
    frontier hidden comes from the join."""
    eng = _engine(params, tok, "medusa")
    try:
        assert eng.draft_k == K
        a1, a2 = _audio(DISTINCT[6]), _audio(DISTINCT[7])
        f1 = eng.submit(a1)
        time.sleep(0.02)
        f2 = eng.submit(a2)
        assert f1.result(timeout=300)["tokens"] == reference(a1)
        assert f2.result(timeout=300)["tokens"] == reference(a2)
        assert eng.stats()["spec_rounds"] > 0
    finally:
        eng.close()


def test_medusa_tree_engine_matches_plain_greedy(params, tok, reference):
    """Tree Medusa, with a mid-flight join through the W-wide tree join."""
    eng = _engine(params, tok, "tree")
    try:
        assert eng.draft_k == 6 and eng._tree_join_width == 6
        a1, a2 = _audio(DISTINCT[0]), _audio(DISTINCT[3])
        f1 = eng.submit(a1)
        time.sleep(0.02)
        f2 = eng.submit(a2)
        assert f1.result(timeout=300)["tokens"] == reference(a1)
        assert f2.result(timeout=300)["tokens"] == reference(a2)
        assert eng.stats()["spec_rounds"] > 0
    finally:
        eng.close()


ENGINE_MODES = ["ngram", "model", "medusa", "tree"]


@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_speculative_engine_int8_cache(params, draft, tok, reference, mode):
    """The int8 cross cache in every mode (the draft's cache is int8 too):
    staggered requests decode JAX's int8-cache tokens."""
    eng = _engine(params, tok, mode, draft=draft, kv_int8=True)
    try:
        audios = [_audio(s) for s in DISTINCT[1:4]]
        futs = []
        for a in audios:
            futs.append(eng.submit(a))
            time.sleep(0.02)
        got = [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        eng.close()
    assert got == [reference(a, kv_int8=True) for a in audios]


@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_speculative_engine_prewarm_and_adaptive(params, draft, tok, reference,
                                                 mode):
    """Prewarm runs each chunk variant (2, 1 and 8 rounds) before the thread
    starts and leaves the stats at 0; adaptive long chunks keep the
    tokens."""
    eng = _engine(params, tok, mode, draft=draft, prewarm=True,
                  adaptive_sync=True)
    try:
        start = eng.stats()
        audios = [_audio(s) for s in DISTINCT[4:7]]
        futs = []
        for a in audios:
            futs.append(eng.submit(a))
            time.sleep(0.02)
        got = [f.result(timeout=300)["tokens"] for f in futs]
        st = eng.stats()
    finally:
        eng.close()
    assert got == [reference(a) for a in audios]
    assert (start["chunks"] == start["spec_rounds"] == start["spec_emitted"]
            == 0)
    assert st["spec_rounds"] > 0


@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_speculative_budget_freeze_truncates_exactly(params, tok, reference,
                                                     mode):
    """A 3-token budget under rounds of up to K + 1 tokens (the self-draft
    accepts all): the budget cuts a round on the device, every K/V write
    stays inside the cache (an index write past it would raise), and the
    host gets exactly the first 3 greedy tokens."""
    eng = _engine(params, tok, mode, draft=params, max_new=3,
                  steps_per_sync=6)
    try:
        audio = _audio(DISTINCT[2])
        out = eng.transcribe(audio, timeout=300)
    finally:
        eng.close()
    ref = reference(audio)
    assert eng.max_new == 3 and eng._cache_len == eng.n_ctx + eng.draft_k
    assert out["tokens"] == ref[:3]
    assert out["truncated"] == (len(ref) > 3)


@pytest.mark.parametrize("kw,message", [
    (dict(draft_params={}), "draft_params and draft_cfg go together"),
    (dict(medusa_params={"heads": [None] * 2}, draft_params={},
          draft_cfg=CFG, draft_k=2), "medusa_params excludes a draft model"),
    (dict(medusa_tree=((-1, 0),)), "medusa_tree needs medusa_params"),
    (dict(medusa_params={"heads": [None] * 2},
          medusa_tree=((-1, 0), (0, 0), (1, 0))), "tree depth 3 exceeds 2 heads"),
    (dict(draft_params={}, draft_cfg=CFG), "a draft model needs draft_k > 0"),
    (dict(draft_params={}, draft_cfg=replace(CFG, n_mels=128), draft_k=3),
     "draft and target must share tokenizer and mel size"),
])
def test_speculative_options_refused_as_jax(params, jax_params, kw, message):
    """The reference's ValueErrors, in its order and with its messages, each
    before any engine thread starts."""
    jkw = dict(kw)
    if "draft_cfg" in kw:
        jkw["draft_cfg"] = replace(JCFG, n_mels=kw["draft_cfg"].n_mels)
    with pytest.raises(ValueError) as want:
        JaxEngine(jax_params, JCFG, **jkw)
    before = threading.active_count()
    with pytest.raises(ValueError) as got:
        ContinuousBatcher(params, CFG, device="cpu", **kw)
    assert str(got.value) == str(want.value) == message
    assert threading.active_count() == before  # no engine thread started
