"""PyTorch port: the in-flight batching engine against the JAX package.

Same weights (numpy bridge), same inputs. ``decode_step_multipos`` and the
engine's device functions (``_join_step``, ``_decode_chunk``) are held
against the JAX package's on the same cache state; the engine itself
against the JAX package's ``decode()`` on each window's log-mel (the
port's, so that both decode the same input), in f32 on the CPU: a request
that joins a running batch decodes exactly the tokens of a standalone
greedy decode. The engine cases are the JAX package's own
(``tests/test_serve_continuous.py``), at its shapes.
"""

import threading
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whisper_ipa_tpu.models.whisper as jax_whisper
import whisper_ipa_tpu.serve_continuous as jax_sc
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode import decode as jax_decode
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
import whisper_ipa_torch.serve_continuous as sc
from whisper_ipa_torch.audio import N_SAMPLES, pad_or_trim
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.models import (
    DecoderCache,
    decode_step_multipos,
    init_cache,
    params_from_numpy,
)
from whisper_ipa_torch.ops import log_mel_spectrogram
from whisper_ipa_torch.serve_continuous import ContinuousBatcher, EngineOverloaded
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

# full 30 s windows, tiny transformer widths (the JAX tests' shapes)
NARROW = dict(n_audio_state=32, n_audio_head=2, n_audio_layer=1,
              n_text_state=32, n_text_head=2, n_text_layer=1, n_text_ctx=24)
CFG = replace(CONFIGS["test-tiny"], **NARROW)
JCFG = replace(JAX_CONFIGS["test-tiny"], **NARROW)
MAX_NEW = 8


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    return params_from_numpy(flat)


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
# (the random model answers most tones alike), so a request that reads
# another slot's state shows
DISTINCT = [0, 1, 7, 9, 10, 17, 25, 31]


@pytest.fixture(scope="module")
def engine(params, tok):
    eng = ContinuousBatcher(params, CFG, device="cpu", slots=2,
                            max_new_tokens=MAX_NEW, steps_per_sync=2,
                            language="en", tokenizer=tok)
    yield eng
    eng.close()
    assert not eng._thread.is_alive()


# -- decode_step_multipos -------------------------------------------------

def _to_jax_cache(cache: DecoderCache):
    def conv(t):
        return None if t is None else jnp.asarray(t.numpy())

    return jax_whisper.DecoderCache(*(conv(t) for t in cache))


def _clone(cache: DecoderCache) -> DecoderCache:
    return DecoderCache(*(None if t is None else t.clone() for t in cache))


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("S", [1, 4])
def test_decode_step_multipos_matches_jax(params, jax_params, kv_int8, S):
    """Logits and the landed self K/V within 1e-5 of JAX's, per-element
    positions from 0 to the last row the cache holds."""
    B, n_ctx = 4, 12
    rng = np.random.default_rng(S)
    feats = torch.from_numpy(
        rng.standard_normal((B, CFG.n_audio_ctx, CFG.n_audio_state)).astype(
            np.float32))
    cache = init_cache(params, CFG, feats, max_len=n_ctx,
                       cross_kv_int8=kv_int8)
    # earlier rows hold K/V from before: random, as a running batch's
    for buf in (cache.self_k, cache.self_v):
        buf.copy_(torch.from_numpy(rng.standard_normal(buf.shape).astype(
            np.float32)))
    pos = np.array([0, 3, n_ctx - S - 1, n_ctx - S])
    tokens = rng.integers(0, CFG.n_vocab, (B, S))
    jcache = _to_jax_cache(cache)
    before = _clone(cache)

    logits, out = decode_step_multipos(
        params, CFG, torch.from_numpy(tokens), cache, torch.from_numpy(pos))
    step = jax.jit(jax_whisper.decode_step_multipos, static_argnames=("cfg",))
    jlogits, jout = step(jax_params, JCFG, jnp.asarray(tokens, jnp.int32),
                         jcache, jnp.asarray(pos, jnp.int32))
    assert out is cache  # landed in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5,
                               rtol=0)
    for got, want, old in ((out.self_k, jout.self_k, before.self_k),
                           (out.self_v, jout.self_v, before.self_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
        changed = (got != old).any(dim=(0, 3)).numpy()  # (B, n_ctx)
        for b in range(B):
            rows = np.nonzero(changed[b])[0]
            assert set(rows) <= set(range(pos[b], pos[b] + S))
    for got, old in zip(out[2:], before[2:]):
        if got is not None:
            assert torch.equal(got, old)  # the cross cache is read only


def test_decode_step_multipos_does_not_clamp(params):
    """A block that would run past n_ctx raises instead of landing at a
    clamped start (the reference's dynamic_update_slice)."""
    feats = torch.zeros((2, CFG.n_audio_ctx, CFG.n_audio_state))
    cache = init_cache(params, CFG, feats, max_len=8)
    with pytest.raises(IndexError):
        decode_step_multipos(params, CFG, torch.zeros((2, 2), dtype=torch.long),
                             cache, torch.tensor([0, 7]))


# -- the engine's device functions against JAX's -------------------------

def _join_rows(prefix, history, lens, joiners):
    """The join block of ``_admit``: joiners get the prefix at 0, the
    others re-feed their last n_prefix tokens in place."""
    P = len(prefix)
    rows = np.tile(np.asarray(prefix), (len(lens), 1))
    pos = np.maximum(np.asarray(lens) - P, 0)
    for b in range(len(lens)):
        if b in joiners:
            pos[b] = 0
            continue
        tail = (list(prefix) + history[b])[pos[b]:pos[b] + P]
        rows[b, :len(tail)] = tail
    return rows, pos


@pytest.mark.parametrize("kv_int8", [False, True])
def test_join_and_chunks_match_jax(params, jax_params, tok, kv_int8):
    """From one cache state, both packages run the same sequence: a join of
    every slot, a 3-round chunk, a re-join of slot 1 while the others
    re-feed, then chunks of 1, 2 and 8 rounds in which every slot halts
    (budget, or finished from the start) partway through the last. The
    tokens, lens, finished and last_tok are equal at every stage and the
    self K/V within 1e-5 on every live row."""
    eng = ContinuousBatcher(params, CFG, device="cpu", slots=3,
                            max_new_tokens=7, tokenizer=tok)
    eng.close()
    P, max_new, B = eng.n_prefix, eng.max_new, 3
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal(
        (B, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    cache = init_cache(params, CFG, feats, max_len=eng.n_ctx,
                       cross_kv_int8=kv_int8)
    jcache = _to_jax_cache(cache)
    state = dict(last_tok=torch.full((B,), eng.prefix[-1]),
                 lens=torch.full((B,), P), finished=torch.zeros(B, dtype=torch.bool))
    jstate = {k: jnp.asarray(v.numpy(), jnp.int32 if k != "finished" else bool)
              for k, v in state.items()}
    masks = (eng.suppress, eng.blank)
    jmasks = tuple(jnp.asarray(m.numpy()) for m in masks)
    history = [[] for _ in range(B)]

    def join(joiners):
        nonlocal cache, jcache
        rows, pos = _join_rows(eng.prefix, history, state["lens"].numpy(), joiners)
        cache = sc._join_step(params, CFG, cache, torch.from_numpy(rows),
                              torch.from_numpy(pos))
        jcache = jax_sc._join_step(jax_params, JCFG, jcache,
                                   jnp.asarray(rows, jnp.int32),
                                   jnp.asarray(pos, jnp.int32))
        for b in joiners:
            history[b] = []
            state["lens"][b] = P
            state["last_tok"][b] = eng.prefix[-1]
            state["finished"][b] = False
        for k in jstate:
            jstate[k] = jnp.asarray(state[k].numpy(), jstate[k].dtype)

    def chunk(rounds):
        nonlocal cache, jcache
        cache, *out, toks, _ = sc._decode_chunk(
            params, CFG, cache, state["last_tok"], state["lens"],
            state["finished"], *masks, eng.eot, rounds, P, max_new,
            check_every=1)  # the reference's exit: the first halted step
        state.update(zip(("last_tok", "lens", "finished"), out))
        jcache, *jout, jtoks = jax_sc._decode_chunk(
            jax_params, JCFG, jcache, jstate["last_tok"], jstate["lens"],
            jstate["finished"], *jmasks, eng.eot, rounds, P, max_new)
        jstate.update(zip(("last_tok", "lens", "finished"), jout))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
        for k in jstate:
            np.testing.assert_array_equal(state[k].numpy(), np.asarray(jstate[k]))
        for b in range(B):
            history[b] += [int(t) for t in toks[:, b] if t >= 0 and t != eng.eot]
            live = int(state["lens"][b]) - 1  # the row at lens-1 is rewritten
            for got, want in ((cache.self_k, jcache.self_k),
                              (cache.self_v, jcache.self_v)):
                np.testing.assert_allclose(got[:, b, :live].numpy(),
                                           np.asarray(want)[:, b, :live],
                                           atol=1e-5, rtol=0)
        return toks

    join([0, 1, 2])
    chunk(3)
    join([1])
    state["finished"][2] = True  # slot 2 halts before the next chunk
    jstate["finished"] = jnp.asarray(state["finished"].numpy())
    chunk(1)
    chunk(2)
    toks = chunk(8)
    assert (toks[-1] == -1).all()  # every slot halted partway
    assert bool((state["lens"][:2] - P >= max_new).all())


@pytest.mark.parametrize("rounds", [1, 2, 8])
def test_halted_check_cadence_keeps_tokens(params, tok, rounds):
    """The all-halted check's cadence changes how many steps run, never the
    tokens, lens, last_tok or which slots have halted (a budget-frozen slot
    is marked finished once a step runs past its halt; halted either way).
    Checking before every step is the reference's exit."""
    eng = ContinuousBatcher(params, CFG, device="cpu", slots=2,
                            max_new_tokens=3, tokenizer=tok)
    eng.close()
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32))
    outs = []
    for every in (1, 1000):
        cache = init_cache(params, CFG, feats, max_len=eng.n_ctx)
        cache = sc._join_step(params, CFG, cache,
                              torch.tensor([eng.prefix] * 2),
                              torch.zeros(2, dtype=torch.long))
        _, last_tok, lens, fin, toks, steps = sc._decode_chunk(
            params, CFG, cache, torch.full((2,), eng.prefix[-1]),
            torch.full((2,), eng.n_prefix), torch.tensor([False, True]),
            eng.suppress, eng.blank, eng.eot, rounds, eng.n_prefix,
            eng.max_new, check_every=every)
        halted = fin | (lens - eng.n_prefix >= eng.max_new)
        outs.append((toks, last_tok, lens, halted, steps))
    (a, *sa, steps_a), (b, *sb, steps_b) = outs
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))
    # slot 0 halts after its EOT or its budget, slot 1 is halted throughout
    eot = (a[:, 0] == eng.eot).nonzero()
    halts_after = int(eot[0]) + 1 if len(eot) else eng.max_new
    assert steps_b == rounds and steps_a == min(rounds, halts_after)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_empty_slots_give_finite_output(params, tok, kv_int8):
    """Before any request, the persistent cache is built from all-zero
    features; a step over it (the int8 path's K4 plain version included)
    gives finite logits."""
    eng = ContinuousBatcher(params, CFG, device="cpu", slots=2,
                            max_new_tokens=4, tokenizer=tok, kv_int8=kv_int8)
    eng.close()
    logits, _ = decode_step_multipos(
        eng.params, CFG, eng.last_tok[:, None], _clone(eng.cache), eng.lens - 1)
    assert bool(torch.isfinite(logits).all())
    if kv_int8:
        assert bool((eng.cache.cross_k_scale >= 0).all())


# -- the engine against JAX's decode() ------------------------------------

def test_single_request_matches_plain_greedy(engine, reference):
    audio = _audio(0)
    out = engine.transcribe(audio, timeout=300)
    assert out["tokens"] == reference(audio)
    assert out["latency_sec"] > 0
    if out["tokens"]:
        assert 0 < out["ttft_sec"] <= out["latency_sec"]


def test_join_does_not_disturb_running_request(engine, reference):
    a1, a2 = _audio(DISTINCT[0]), _audio(DISTINCT[2])
    f1 = engine.submit(a1)
    time.sleep(0.05)  # a1 decodes before a2 joins
    f2 = engine.submit(a2)
    assert f1.result(timeout=300)["tokens"] == reference(a1)
    assert f2.result(timeout=300)["tokens"] == reference(a2)


def test_more_requests_than_slots(engine, reference):
    audios = [_audio(seed) for seed in DISTINCT[1:6]]
    futs = [engine.submit(a) for a in audios]
    for a, f in zip(audios, futs):
        assert f.result(timeout=300)["tokens"] == reference(a)
    assert len({tuple(reference(a)) for a in audios}) == len(audios)
    assert engine.stats()["requests"] >= 5


@pytest.mark.parametrize("variant", [
    dict(join_fast_sync=True),
    dict(join_fast_sync=False),
    dict(adaptive_sync=True),
    dict(prewarm=True),
    dict(kv_int8=True),
])
def test_engine_variants_match_plain_greedy(params, tok, reference, variant):
    """Fast sync on and off, adaptive sync, prewarm and the int8 cross
    cache: staggered requests decode JAX's tokens, and the mode fires."""
    eng = ContinuousBatcher(params, CFG, device="cpu", slots=2,
                            max_new_tokens=MAX_NEW, steps_per_sync=2,
                            language="en", tokenizer=tok, **variant)
    try:
        start = eng.stats()
        audios = [_audio(seed) for seed in DISTINCT[5:]]
        futs = []
        for a in audios:
            futs.append(eng.submit(a))
            time.sleep(0.02)  # joins land mid-flight
        got = [f.result(timeout=300)["tokens"] for f in futs]
        st = eng.stats()
    finally:
        eng.close()
    kv_int8 = variant.get("kv_int8", False)
    assert got == [reference(a, kv_int8=kv_int8) for a in audios]
    if variant.get("prewarm"):
        assert start["chunks"] == start["steps"] == start["fast_chunks"] == 0
    if "join_fast_sync" in variant:
        assert (st["fast_chunks"] >= 1) == variant["join_fast_sync"]
    if variant.get("adaptive_sync"):
        assert st["long_chunks"] >= 1


def test_token_streaming_callback(engine):
    seen = []
    out = engine.submit(_audio(DISTINCT[3]),
                        on_token=seen.append).result(timeout=300)
    assert [s["token"] for s in seen] == out["tokens"]
    assert all(s["window"] == 0 for s in seen)
    if seen:
        assert seen[-1]["text_so_far"].strip() == out["text"]


def test_long_audio_chains_windows(engine, reference):
    audio = _audio(5, N_SAMPLES + 16000)
    out = engine.transcribe(audio, timeout=300)
    assert out["n_windows"] == 2
    assert out["tokens"] == reference.windows(audio)


def test_engine_fuzz_mixed_arrivals(engine, reference):
    """Mixed lengths under random arrival jitter: every request equals its
    standalone per-window greedy decode."""
    rng = np.random.default_rng(14)
    audios = [_audio(40 + i, int(rng.integers(8000, N_SAMPLES + 24000)))
              for i in range(6)]
    futs = []
    for a in audios:
        futs.append(engine.submit(a))
        time.sleep(float(rng.uniform(0, 0.03)))
    for a, f in zip(audios, futs):
        assert f.result(timeout=300)["tokens"] == reference.windows(a)


def test_device_budget_freeze_truncates_exactly(params, tok, reference):
    """steps_per_sync past max_new: the budget holds on the device, so the
    K/V writes stay inside the cache and the host gets max_new tokens."""
    eng = ContinuousBatcher(params, CFG, device="cpu", slots=2,
                            max_new_tokens=3, steps_per_sync=6,
                            language="en", tokenizer=tok)
    try:
        audio = _audio(0)
        out = eng.transcribe(audio, timeout=300)
    finally:
        eng.close()
    ref = reference(audio)
    assert eng.n_ctx == eng.n_prefix + 3 + 1
    assert out["tokens"] == ref[:3]
    assert out["truncated"] == (len(ref) > 3)


def test_max_pending_backpressure(engine):
    engine.max_pending = 0  # every submit sees a full queue
    try:
        with pytest.raises(EngineOverloaded):
            engine.submit(np.zeros(8000, np.float32))
        assert engine.stats()["rejected"] >= 1
    finally:
        engine.max_pending = None


def test_concurrent_submits_count_every_request(params, tok):
    """Eight client threads submit and cancel at once (a short switch
    interval): no request is lost from the counts, and every one of them
    is counted as cancelled once."""
    import sys

    eng = ContinuousBatcher(params, CFG, device="cpu", slots=2,
                            max_new_tokens=MAX_NEW, tokenizer=tok)
    silence = np.zeros(1600, np.float32)

    def client():
        for _ in range(16):
            eng.submit(silence).cancel()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        clients = [threading.Thread(target=client) for _ in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not any(c.is_alive() for c in clients)
    finally:
        sys.setswitchinterval(interval)
    stop = time.time() + 60
    while eng.stats()["cancelled"] < 128 and time.time() < stop:
        time.sleep(0.01)
    st = eng.stats()
    eng.close()
    assert st["requests"] == 128 and st["cancelled"] == 128
    assert st["pending"] == 0


def test_cancel_queued_request(engine, reference):
    fut = engine.submit(np.zeros(16000, np.float32))
    assert fut.cancel()
    audio = _audio(DISTINCT[4])
    assert engine.transcribe(audio, timeout=300)["tokens"] == reference(audio)
    assert engine.stats()["cancelled"] >= 1
    with pytest.raises(Exception):
        fut.result(timeout=0)


@pytest.mark.parametrize("case", ["expired", "inflight", "queued_full"])
def test_deadlines(engine, reference, case):
    """A deadline past while queued resolves before any encoder pass; one
    that expires mid-decode returns the tokens so far; an expired request
    behind full slots resolves while they decode."""
    before = engine.stats()["timed_out"]
    if case == "expired":
        out = engine.submit(np.zeros(16000, np.float32),
                            deadline_sec=0).result(timeout=300)
        assert out["timed_out"] is True and out["tokens"] == []
        assert out["queue_sec"] is None  # never started
    elif case == "inflight":
        audio = _audio(DISTINCT[6])
        fut = engine.submit(audio, deadline_sec=3600)
        stop = time.time() + 120
        while time.time() < stop and not fut.done():
            hit = [s for s in engine._slots if s is not None and s.deadline]
            if hit:
                hit[0].deadline = 0.0  # pull the deadline into the past
                break
            time.sleep(0.001)
        out = fut.result(timeout=300)
        ref = reference(audio)
        if out["timed_out"]:
            assert out["tokens"] == ref[:len(out["tokens"])]
        else:  # finished before the reaper saw it: still exact
            assert out["tokens"] == ref
        audio2 = _audio(DISTINCT[7])
        assert engine.transcribe(audio2, timeout=300)["tokens"] == reference(audio2)
        return
    else:
        longs = [_audio(24 + i, N_SAMPLES + 16000) for i in range(2)]
        futs = [engine.submit(a) for a in longs]
        fq = engine.submit(np.zeros(16000, np.float32), deadline_sec=0)
        out = fq.result(timeout=120)  # resolves while both slots decode
        assert out["timed_out"] is True and out["tokens"] == []
        for a, f in zip(longs, futs):
            r = f.result(timeout=300)
            assert r["n_windows"] == 2 and r["tokens"] == reference.windows(a)
    assert engine.stats()["timed_out"] > before


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_thread_failure_fails_pending_futures(params, tok, monkeypatch):
    """An engine-thread error fails every pending request with it; nothing
    falls back."""
    eng = ContinuousBatcher(params, CFG, device="cpu", slots=1,
                            max_new_tokens=MAX_NEW, tokenizer=tok)

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(sc, "_decode_chunk", broken)
    futs = [eng.submit(_audio(50 + i)) for i in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            f.result(timeout=120)
    eng._thread.join(timeout=30)
    assert not eng._thread.is_alive()
    eng.close()


def _mesh(data, model):
    return SimpleNamespace(shape={"data": data, "model": model})


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=_mesh(1, 1), tensor_parallel=True), "'model' axis > 1"),
    (dict(mesh=_mesh(3, 1), slots=4), "must divide by the mesh data axis"),
])
def test_unported_options_raise(params, kw, match):
    """The mesh options the reference refuses: TP without a 'model' axis
    and slots the 'data' axis does not divide (the engine over a mesh
    runs in tests/test_torch_engine_mesh.py)."""
    before = threading.active_count()
    with pytest.raises(ValueError, match=match):
        ContinuousBatcher(params, CFG, device="cpu", **kw)
    assert threading.active_count() == before  # no engine thread started


def test_cuda_is_the_default_device(params):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="is_available"):
        ContinuousBatcher(params, CFG)
