"""PyTorch port: the in-flight engine over a mesh, speculation over TP in
the service, and training's cached encoder and resume over ranks, against
the JAX package.

Gloo worlds of 2 and 4 CPU ranks (``tests/torch_ranks.py``) run, in f32 on
the JAX package's seeded weights (``models.convert.flatten_params`` names)
and seeded inputs:

* ``decode_step_multipos_hidden`` and ``decode_step_block`` at TP 2 from
  one cache state, float and int8 cross caches: logits and the written
  self K/V within 1e-5 of JAX's, the final-LN hidden states (unit scale,
  the row-parallel sums in another order) within 1e-4;
* the engine at data 2, TP 2 and data 2 x TP 2 (the JAX package's
  ``test_dp_sharded_engine_matches_plain_greedy``,
  ``test_tp_sharded_engine_matches_plain_greedy`` and
  ``test_dp_tp_sharded_engine_matches_plain_greedy``), at TP 2 and data
  2 x TP 2 with adaptive sync (long chunks that the all-halted check
  stops early, at the same step on both ranks of a TP group), at TP 2 with
  n-gram drafts, a draft model, a Medusa chain and a tree, and at data 2
  with n-gram drafts, prewarm and adaptive sync: every request's
  tokens equal the JAX package's ``decode()`` on its windows, every TP
  rank's host syncs are equal, and each rank's cache holds slots / data
  slots and heads / TP heads;
* the micro-batch service at TP 2 with a draft model, a Medusa chain and
  a tree: texts equal the JAX package's ``decode()``;
* ``train(cache_encoder=True)`` under TP 2 and FSDP with a directory a
  rank: each rank's cached features equal the one-rank run's; the two
  steps' losses lie within 1e-5 relative of the one-rank run's under TP,
  and under FSDP, whose data ranks sample their own rows, of a DP run's
  on the same rows (its features the one-rank run's too);
* resume from a 2-step checkpoint under DP, ZeRO-1 and FSDP with a
  directory a rank, only rank 0's holding it: rank 0's state is broadcast
  and the next step's loss equals a shared-directory resume's;
* ``cli.serve --continuous --dp 2`` through ``build_server``, with float
  and with int8 weights (replicated): rank 0 answers a request with JAX's
  tokens while rank 1 follows;
* an engine at TP 2 whose rank 0 fails between commands or inside one:
  rank 1's ``follow()`` raises instead of waiting.

The JAX references and the one-rank runs compute here while the ranks run.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_ipa_tpu.models.whisper as jax_whisper
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode import decode as jax_decode
from whisper_ipa_tpu.models import flatten_params as jax_flatten
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save_safetensors
from whisper_ipa_tpu.ops.quant import quantize_params as jax_quantize
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.audio import N_SAMPLES, load_audio, pad_or_trim
from whisper_ipa_torch.ops import log_mel_spectrogram
from whisper_ipa_torch.train.loop import train

import torch_ranks
from test_torch_data import write_dataset

torch.set_num_threads(1)

# full 30 s windows, tiny widths (the engine tests' shapes); 2 heads, so
# TP 2 leaves one a rank
NARROW = dict(n_audio_state=32, n_audio_head=2, n_audio_layer=1,
              n_text_state=32, n_text_head=2, n_text_layer=1, n_text_ctx=24)
JCFG = replace(JAX_CONFIGS["test-tiny"], **NARROW)
MAX_NEW = 8
# seeded tones the random model decodes to different sequences
DISTINCT = [0, 1, 7, 9, 10, 17, 25, 31]
LONG = len(DISTINCT)  # a 31 s clip: two windows
SERVICE_CLIPS = [3, 4]


def _audio(seed: int, n: int = None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = n or 16000 * (1 + seed % 4)
    freq = rng.uniform(100, 4000)
    tone = rng.uniform(0.05, 0.5) * np.sin(2 * np.pi * freq * np.arange(n) / 16000)
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _mel(audio) -> np.ndarray:
    return log_mel_spectrogram(torch.from_numpy(pad_or_trim(audio)),
                               JCFG.n_mels).numpy()


def _windows(audio):
    return [audio[s:s + N_SAMPLES] for s in range(0, len(audio), N_SAMPLES)]


def _npz(path, params):
    np.savez(path, **{k: np.asarray(v) for k, v in jax_flatten(params).items()})
    return path


def _heads(n: int, seed: int):
    """Seeded Medusa heads with a nonzero residual, as numpy."""
    rng = np.random.default_rng(seed)
    d = JCFG.n_text_state
    return {"heads": [
        {"w1": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
         "b1": 0.1 * rng.standard_normal(d).astype(np.float32),
         "w2": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
         "b2": 0.1 * rng.standard_normal(d).astype(np.float32)}
        for _ in range(n)]}


def _multipos_state():
    """One cache state and the two steps' inputs: multipos at per-row
    positions up to the last rows; a tree-like block (3 re-fed tokens,
    two siblings sharing a position) writing the re-fed ones."""
    rng = np.random.default_rng(11)
    B, n_ctx, S = 4, 12, 3
    shape = (JCFG.n_text_layer, B, n_ctx, JCFG.n_text_state)
    start = np.array([0, 2, 5, 4])
    block_pos = start[:, None] + np.array([0, 1, 2, 3, 3])[None]
    allowed = np.tril(np.ones((5, 5), bool))
    allowed[4, 3] = False  # the siblings do not see each other
    mask = np.where(allowed, 0.0, -np.inf).astype(np.float32)
    return dict(
        feats=rng.standard_normal(
            (B, JCFG.n_audio_ctx, JCFG.n_audio_state)).astype(np.float32),
        self_k=rng.standard_normal(shape).astype(np.float32),
        self_v=rng.standard_normal(shape).astype(np.float32),
        n_ctx=n_ctx,
        tokens=rng.integers(0, JCFG.n_vocab, (B, S)),
        pos=np.array([0, 3, n_ctx - S - 1, n_ctx - S]),
        block_tokens=rng.integers(0, JCFG.n_vocab, (B, 5)),
        block_pos=block_pos, frontier=start,
        mask=np.tile(mask, (B, 1, 1)), write_len=3,
    )


def _engine(key, data, model, mode, slots, clips, **kw):
    return (key, "engine", dict(data=data, model=model, mode=mode,
                                slots=slots, clips=clips, **kw))


WORLD2 = [
    ("multipos", "multipos_tp", {}),
    _engine("dp2", 2, 1, "plain", 4, [0, 1, 2, 3, LONG, 4, 5]),
    _engine("tp2", 1, 2, "plain", 2, [0, 1, 2]),
    # long chunks of 16 steps (2 a sync x 8): a slot has at most 7 tokens
    # left after its join's 1-step chunk, so the all-halted check stops
    # every long chunk early
    _engine("tp2 adaptive", 1, 2, "plain", 2, [0, 1, 2], adaptive_sync=True,
            adaptive_mult=8),
    _engine("tp2 ngram", 1, 2, "ngram", 2, [3, 4, 5]),
    _engine("tp2 model", 1, 2, "model", 2, [6, 7]),
    _engine("tp2 medusa", 1, 2, "medusa", 2, [0, 3, 6]),
    _engine("tp2 tree", 1, 2, "tree", 2, [1, 4, 7]),
    _engine("dp2 ngram prewarm adaptive", 2, 1, "ngram", 4, [2, 5, 6],
            gap=0.3, prewarm=True, adaptive_sync=True),
    ("svc draft", "service_spec", dict(mode="draft")),
    ("svc medusa", "service_spec", dict(mode="medusa")),
    ("svc tree", "service_spec", dict(mode="tree")),
    ("cache tp", "cache_encoder", dict(kind="tp")),
    ("cache fsdp", "cache_encoder", dict(kind="fsdp")),
    ("cache dp", "cache_encoder", dict(kind="dp")),
    ("resume dp", "resume", dict(kind="dp")),
    ("resume zero1", "resume", dict(kind="zero1")),
    ("resume fsdp", "resume", dict(kind="fsdp")),
    ("serve", "serve_continuous", {}),
    ("serve q8", "serve_continuous", dict(flags=["--quant-bits", "8"])),
    # last: a leader that fails inside a command tears the group down
    ("leader fails between", "engine_leader_fails", dict(inside=False)),
    ("leader fails inside", "engine_leader_fails", dict(inside=True)),
]
WORLD4 = [_engine("dp2 tp2", 2, 2, "plain", 4, [0, 1, 2, 3, 4, 5]),
          _engine("dp2 tp2 adaptive", 2, 2, "plain", 4, [0, 1, 2, 3, 4, 5],
                  adaptive_sync=True, adaptive_mult=8)]


def _read_losses(out):
    import csv

    with open(os.path.join(out, "training_log.csv")) as f:
        return {int(r["step"]): float(r["loss"]) for r in csv.DictReader(f)}


def _one_rank_train(plan, out, **kw):
    train("test-tiny", plan["dataset"], plan["dataset"], out, batch_size=2,
          learning_rate=1e-4, validate_every=0, save_every=0,
          weights=plan["weights"], final_validate=False, device="cpu",
          seed=3, **kw)
    return _read_losses(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine_mesh")
    jparams = jax_init_params(JCFG, seed=0)
    clips = [_audio(s) for s in DISTINCT] + [_audio(8, N_SAMPLES + 16000)]
    plan = dict(
        engine_cfg=NARROW, max_new=MAX_NEW, clips=clips,
        engine_params=_npz(str(root / "p.npz"), jparams),
        draft_params=_npz(str(root / "d.npz"), jax_init_params(JCFG, seed=9)),
        heads3=_heads(3, seed=1), heads4=_heads(4, seed=2),
        service_clips=SERVICE_CLIPS, mp=_multipos_state(),
        dataset=str(root / "ds" / "dataset.json"),
        weights=str(root / "test-tiny.safetensors"),
        wavs=[str(root / "ds" / "utt0.wav")],
        resume_run=str(root / "resume_run"), ready=str(root / "ready"),
    )
    # the ranks start on the engine; the training cases wait for "ready"
    h2 = torch_ranks.start(2, dict(plan, scenarios=WORLD2), str(root / "w2"))
    h4 = torch_ranks.start(4, dict(plan, scenarios=WORLD4), str(root / "w4"))
    assert write_dataset(str(root / "ds"), n=6, seconds=0.3) == plan["dataset"]
    tiny = jax_init_params(JAX_CONFIGS["test-tiny"], seed=0)
    jax_save_safetensors(plan["weights"], tiny)
    # the checkpoint the resume cases start from: one rank, 2 steps
    resume_losses = _one_rank_train(plan, plan["resume_run"], num_steps=2)
    open(plan["ready"], "w").close()
    jtok = jax_get_tokenizer(multilingual=True, language="en")
    ref = dict(resume=resume_losses, jparams=jparams)

    def greedy(audio):
        out = []
        for w in _windows(audio):
            res = jax_decode(jparams, JCFG, jnp.asarray(_mel(w))[None],
                             JaxOptions(language="en", without_timestamps=True,
                                        sample_len=MAX_NEW), tokenizer=jtok)
            out.extend(res[0].tokens)
        return out

    ref["greedy"] = [greedy(a) for a in clips]
    mels = jnp.asarray(np.stack([_mel(clips[k]) for k in SERVICE_CLIPS]))
    ref["service"] = [r.text for r in jax_decode(
        jparams, JCFG, mels, JaxOptions(language="en", without_timestamps=True,
                                        kv_int8=True), tokenizer=jtok)]
    mel = jnp.asarray(_mel(load_audio(plan["wavs"][0])))[None]
    serve_options = JaxOptions(language="en", without_timestamps=True,
                               sample_len=MAX_NEW, kv_int8=True)
    ref["serve"] = jax_decode(tiny, JAX_CONFIGS["test-tiny"], mel,
                              serve_options, tokenizer=jtok)[0].tokens
    ref["serve q8"] = jax_decode(jax_quantize(tiny, bits=8),
                                 JAX_CONFIGS["test-tiny"], mel, serve_options,
                                 tokenizer=jtok)[0].tokens
    cache_run = str(root / "cache_one_rank")
    ref["cache_losses"] = _one_rank_train(plan, cache_run, num_steps=2,
                                          cache_encoder=True)
    cache = os.path.join(cache_run, "encoder_cache")
    ref["cache_feats"] = {f: np.load(os.path.join(cache, f))
                          for f in os.listdir(cache)}
    ranks2, _ = torch_ranks.collect(h2)
    ranks4, _ = torch_ranks.collect(h4)
    return dict(w2=ranks2, w4=ranks4, ref=ref, plan=plan)


# -- the multi-position steps at TP 2 ---------------------------------------

@pytest.mark.parametrize("name", ["multipos", "block"])
@pytest.mark.parametrize("kv_int8", [False, True])
def test_multipos_steps_at_tp2_match_jax(runs, name, kv_int8):
    """Logits and the written self K/V within 1e-5 of JAX's on one cache
    state, hidden states within 1e-4; each rank holds one head of two."""
    mp, jparams = runs["plan"]["mp"], runs["ref"]["jparams"]
    jcache = jax_whisper.init_cache(
        jparams, JCFG, jnp.asarray(mp["feats"]), max_len=mp["n_ctx"],
        cross_kv_int8=kv_int8)._replace(self_k=jnp.asarray(mp["self_k"]),
                                        self_v=jnp.asarray(mp["self_v"]))
    if name == "multipos":
        jl, jc, jh = jax_whisper.decode_step_multipos_hidden(
            jparams, JCFG, jnp.asarray(mp["tokens"], jnp.int32), jcache,
            jnp.asarray(mp["pos"], jnp.int32))
    else:
        jl, jc, jh = jax_whisper.decode_step_block(
            jparams, JCFG, jnp.asarray(mp["block_tokens"], jnp.int32), jcache,
            jnp.asarray(mp["block_pos"], jnp.int32),
            jnp.asarray(mp["frontier"], jnp.int32), jnp.asarray(mp["mask"]),
            write_len=mp["write_len"])
    for rank in runs["w2"]:
        got = rank["multipos"][f"{name} int8={kv_int8}"]
        assert got["local"][-1] == JCFG.n_text_state // 2
        np.testing.assert_allclose(got["logits"], np.asarray(jl), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["hidden"], np.asarray(jh), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["self_k"], np.asarray(jc.self_k), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["self_v"], np.asarray(jc.self_v), atol=1e-5,
                                   rtol=0)
    a, b = (r["multipos"][f"{name} int8={kv_int8}"]["logits"] for r in runs["w2"])
    assert np.array_equal(a, b)  # all-reduced: the same on both ranks


# -- the engine over a mesh --------------------------------------------------

ENGINE_CASES = [("w2", "dp2", 2, 1), ("w2", "tp2", 1, 2), ("w4", "dp2 tp2", 2, 2),
                ("w2", "tp2 adaptive", 1, 2), ("w4", "dp2 tp2 adaptive", 2, 2),
                ("w2", "tp2 ngram", 1, 2), ("w2", "tp2 model", 1, 2),
                ("w2", "tp2 medusa", 1, 2), ("w2", "tp2 tree", 1, 2),
                ("w2", "dp2 ngram prewarm adaptive", 2, 1)]


@pytest.mark.parametrize("world,key,data,model", ENGINE_CASES,
                         ids=[c[1] for c in ENGINE_CASES])
def test_engine_over_mesh_matches_jax_decode(runs, world, key, data, model):
    """Every request's tokens are the JAX package's greedy decode of its
    windows; the ranks of a TP group read equal host syncs; each rank's
    state holds its block of slots and its heads."""
    ranks = runs[world]
    kw = next(kw for k, _, kw in WORLD2 + WORLD4 if k == key)
    clips, slots = kw["clips"], kw["slots"]
    lead = ranks[0][key]
    assert lead["tokens"] == [runs["ref"]["greedy"][k] for k in clips]
    for r, rank in enumerate(ranks):
        res = rank[key]
        sh = res["shapes"]
        assert sh["self_k"][1] == sh["cross_k"][1] == sh["lens"][0] == slots // data
        assert sh["self_k"][3] == JCFG.n_text_state // model
        assert sh["query_w"] == (JCFG.n_text_state, JCFG.n_text_state // model)
        if "draft_self_k" in sh:  # the replicated draft keeps every head
            assert sh["draft_self_k"][3] == JCFG.n_text_state
        if "hidden_frontier" in sh:
            assert sh["hidden_frontier"] == (slots // data, JCFG.n_text_state)
        # rank r's TP partner holds the same data block and the same syncs
        partner = ranks[r ^ 1] if model == 2 else rank
        got, want = res["syncs"], partner[key]["syncs"]
        assert len(got) == len(want) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert res["stats"]["chunks"] == lead["stats"]["chunks"]
    stats = lead["stats"]
    assert stats["joins"] == sum(len(_windows(runs["plan"]["clips"][k]))
                                 for k in clips)
    if kw["mode"] != "plain":
        assert stats["spec_rounds"] > 0
    if "adaptive" in key:  # long chunks while nothing waits to join
        assert stats["long_chunks"] > 0
    if "adaptive" in key and kw["mode"] == "plain":
        # the all-halted check stopped chunks early, at the same step on
        # both ranks of a TP group (or one would wait in an all-reduce)
        for r, rank in enumerate(ranks):
            res, partner = rank[key], ranks[r ^ 1][key]
            assert res["asked"] == lead["asked"]
            assert res["stats"]["steps"] == partner["stats"]["steps"] < res["asked"]
    if key == "tp2 model":  # the target as its own draft: runs of accepts
        assert stats["spec_emitted"] > stats["spec_slot_rounds"]


# -- the service's speculation at TP 2 ----------------------------------------

@pytest.mark.parametrize("mode", ["draft", "medusa", "tree"])
def test_service_speculation_at_tp2_matches_jax(runs, mode):
    got = runs["w2"][0][f"svc {mode}"]
    assert got["texts"] == runs["ref"]["service"]
    assert runs["w2"][1][f"svc {mode}"] is None  # rank 1 followed


# -- training: the cached encoder and resume ----------------------------------

@pytest.mark.parametrize("kind", ["tp", "fsdp", "dp"])
def test_cache_encoder_over_ranks_matches_one_rank(runs, kind):
    """Each rank holds the features of the rows it reads, equal to the
    one-rank run's (FSDP and DP run the same weights: bit for bit; TP sums
    the heads' partial products in another order: within one float16
    step); rank 0's two losses within 1e-5 relative of the one-rank run's
    (TP, the same rows) or of the DP run's (FSDP)."""
    ref = runs["ref"]
    rows = [sorted(r[f"cache {kind}"]["feats"]) for r in runs["w2"]]
    if kind == "tp":
        assert rows[0] == rows[1] == sorted(ref["cache_feats"])
    else:  # each data rank its own block
        assert not set(rows[0]) & set(rows[1])
        assert sorted(rows[0] + rows[1]) == sorted(ref["cache_feats"])
    for rank in runs["w2"]:
        for name, feat in rank[f"cache {kind}"]["feats"].items():
            want = ref["cache_feats"][name]
            if kind == "tp":
                np.testing.assert_allclose(feat.astype(np.float32),
                                           want.astype(np.float32),
                                           rtol=1e-3, atol=1e-3)
            else:
                assert np.array_equal(feat, want)
    got = runs["w2"][0][f"cache {kind}"]["losses"]
    want = {"tp": ref["cache_losses"], "fsdp": runs["w2"][0]["cache dp"]["losses"],
            "dp": got}[kind]
    assert sorted(got) == sorted(want) == [1, 2]
    for step, loss in want.items():
        assert abs(got[step] - loss) <= 1e-5 * abs(loss)


@pytest.mark.parametrize("kind", ["dp", "zero1", "fsdp"])
def test_resume_without_a_shared_directory(runs, kind):
    """Only rank 0's directory holds the checkpoint: the ranks see their
    steps disagree, take rank 0's state, and the third step's loss equals
    the shared-directory resume's."""
    for rank in runs["w2"]:
        res = rank[f"resume {kind}"]
        assert res["own"]["broadcast"] and not res["shared"]["broadcast"]
    res = runs["w2"][0][f"resume {kind}"]
    own, shared = res["own"]["losses"], res["shared"]["losses"]
    assert {s: own[s] for s in (1, 2)} == runs["ref"]["resume"]
    assert abs(own[3] - shared[3]) <= 1e-6 * abs(shared[3])


@pytest.mark.parametrize("where", ["between", "inside"])
def test_engine_leader_failure_releases_followers(runs, where):
    """Rank 0's engine fails: its request raises, its thread stops, and
    rank 1's follow() raises instead of waiting for a command. Between
    commands rank 0 says so and keeps its group; inside one (rank 1 in
    the chunk's all-reduce) it tears the group down."""
    r0, r1 = (r[f"leader fails {where}"] for r in runs["w2"])
    assert r0["error"] == "injected failure" and not r0["alive"]
    assert r1["raised"] is not None
    if where == "between":
        assert r0["group"] and r1["raised"].startswith("LeaderFailed")
    else:
        assert not r0["group"] and "closed" in r1["raised"].lower()


@pytest.mark.parametrize("key", ["serve", "serve q8"])
def test_cli_serve_continuous_dp2(runs, key):
    """cli.serve --continuous --dp 2 (and --quant-bits 8): rank 0 answers
    with JAX's tokens, each rank holds 2 of the 4 slots."""
    r0, r1 = (r[key] for r in runs["w2"])
    assert r0["answer"]["tokens"] == runs["ref"][key]
    assert r0["local"][1] == r1["local"][1] == 2
