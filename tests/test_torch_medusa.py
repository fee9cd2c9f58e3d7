"""PyTorch port: Medusa heads and tree verification against the JAX package.

Heads are carried across with ``medusa_from_numpy`` (the two packages
draw random numbers from different generators): ``medusa_propose`` and
``medusa_propose_topk`` give JAX's drafts, ties ordered as
``jax.lax.top_k`` orders them; ``medusa_losses`` and its gradients match
``jax.value_and_grad``; five ``train_medusa_step`` steps follow
``optax.adam``'s trajectory; heads files written by either package load in
the other; ``valid_target_mask``, ``optimize_tree`` and ``tree_for_heads``
give JAX's answers. In f32, Medusa chain speculation and
``medusa_tree_decode`` on ``DEFAULT_TREE`` and a custom tree, over the
float and int8 caches, give JAX's tokens and ``SpeculativeStats`` and the
port's ``decode()`` tokens; the micro-batching service with Medusa heads
(chain and tree) answers with the plain service's texts.
"""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode.medusa_tree import medusa_tree_decode as jax_tree_decode
from whisper_ipa_tpu.decode.medusa_tree import optimize_tree as jax_optimize_tree
from whisper_ipa_tpu.decode.medusa_tree import tree_for_heads as jax_tree_for_heads
from whisper_ipa_tpu.decode.speculative import speculative_decode as jax_spec
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models import medusa as jax_medusa
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.audio import SAMPLE_RATE
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import (
    DecodingOptions,
    decode,
    medusa_tree_decode,
    speculative_decode,
)
from whisper_ipa_torch.decode.medusa_tree import (
    DEFAULT_TREE,
    _tree_tables,
    optimize_tree,
    tree_for_heads,
)
from whisper_ipa_torch.models import (
    flatten_params,
    medusa_from_numpy,
    medusa_to_numpy,
    params_from_numpy,
)
from whisper_ipa_torch.models.medusa import (
    init_medusa_params,
    load_medusa,
    medusa_losses,
    medusa_propose,
    medusa_propose_topk,
    save_medusa,
    train_medusa_step,
    valid_target_mask,
)
from whisper_ipa_torch.serve import TranscriptionService
from whisper_ipa_torch.tokenizer import get_tokenizer
from whisper_ipa_torch.train.optimizer import Optimizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=64)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=64)
D = CFG.n_text_state
EOT = 50257


def _heads(n: int, seed: int):
    """Seeded heads with every tensor nonzero (fresh heads are the
    identity), as host arrays."""
    rng = np.random.default_rng(seed)
    return {"heads": [
        {"w1": (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32),
         "b1": (0.1 * rng.standard_normal(D)).astype(np.float32),
         "w2": (0.3 * rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32),
         "b2": (0.1 * rng.standard_normal(D)).astype(np.float32)}
        for _ in range(n)]}


def _jax_heads(heads):
    return jax.tree_util.tree_map(jnp.asarray, heads)


@pytest.fixture(scope="module")
def models():
    jt = jax_init_params(JCFG, seed=0)
    return dict(jt=jt, t=params_from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten_params(jt).items()}))


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return rng.standard_normal((2, 64, CFG.n_mels)).astype(np.float32)


@pytest.fixture(scope="module")
def toks():
    return (get_tokenizer(multilingual=True, language="en"),
            jax_get_tokenizer(multilingual=True, language="en"))


# -- heads ----------------------------------------------------------------

def test_init_shapes_and_seed():
    """The reference's shapes and scales; seeded (another generator)."""
    a, b = init_medusa_params(CFG, 3, seed=1), init_medusa_params(CFG, 3, seed=1)
    ref = jax_medusa.init_medusa_params(JCFG, n_heads=3, seed=1)
    assert len(a["heads"]) == 3
    for h, hb, hr in zip(a["heads"], b["heads"], ref["heads"]):
        for k in ("w1", "b1", "w2", "b2"):
            assert tuple(h[k].shape) == hr[k].shape and h[k].dtype == torch.float32
            assert torch.equal(h[k], hb[k])
        assert not h["b1"].any() and not h["w2"].any() and not h["b2"].any()
        assert abs(float(h["w1"].std()) / float(np.std(hr["w1"])) - 1) < 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_propose_matches_jax(models, dtype):
    heads = _heads(3, seed=1)
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((5, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax_medusa.medusa_propose(
        _jax_heads(heads), models["jt"], jnp.asarray(hidden).astype(jdt), jdt))
    want_k = np.asarray(jax_medusa.medusa_propose_topk(
        _jax_heads(heads), models["jt"], jnp.asarray(hidden).astype(jdt), 4, jdt))
    h = torch.from_numpy(hidden).to(tdt)
    mp = medusa_from_numpy(heads)
    got = medusa_propose(mp, models["t"], h, tdt)
    got_k = medusa_propose_topk(mp, models["t"], h, 4, tdt)
    assert got.tolist() == want.tolist()
    assert torch.equal(got_k[..., 0], got)
    if dtype == "float32":
        assert got_k.tolist() == want_k.tolist()
    else:  # bf16 heads round in other places: the lower candidates may swap
        assert got_k[..., 0].tolist() == want_k[..., 0].tolist()


def test_topk_ties_take_the_lower_index(models):
    """An embedding with repeated rows gives equal logits; the candidates
    follow jax.lax.top_k's order (lower index first)."""
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(models["jt"]).items()}
    emb = flat["decoder.token_embedding"].copy()
    emb[[900, 40, 7000, 3]] = emb[12345]  # five rows equal
    flat["decoder.token_embedding"] = emb
    jparams = {"decoder": {"token_embedding": jnp.asarray(emb)}}
    params = {"decoder": {"token_embedding": torch.from_numpy(emb)}}
    heads = _heads(2, seed=4)
    hidden = np.tile(emb[12345], (3, 1)) * 4.0  # favours the repeated row
    want = np.asarray(jax_medusa.medusa_propose_topk(
        _jax_heads(heads), jparams, jnp.asarray(hidden), 6))
    got = medusa_propose_topk(medusa_from_numpy(heads), params,
                              torch.from_numpy(hidden), 6)
    assert got.tolist() == want.tolist()
    # the ties are in the candidates, lower index first
    tied = {3, 40, 900, 7000, 12345}
    for cands in got.reshape(-1, 6).tolist():
        seen = [c for c in cands if c in tied]
        assert len(seen) >= 4 and seen == sorted(seen)


def test_valid_target_mask_matches_jax():
    tokens = np.array([[5, 7, EOT, EOT, EOT], [EOT] * 5, [1, 2, 3, 4, 5]])
    want = np.asarray(jax_medusa.valid_target_mask(jnp.asarray(tokens), EOT))
    got = valid_target_mask(torch.from_numpy(tokens), EOT)
    assert got.tolist() == want.tolist() == [
        [True, True, True, False, False],
        [True, False, False, False, False],
        [True] * 5,
    ]


def _train_batch():
    rng = np.random.default_rng(6)
    tokens = np.full((3, 10), EOT, np.int32)
    tokens[:, :4] = [50258, 50259, 50359, 50363]
    for b, n in enumerate((5, 3, 6)):
        tokens[b, 4:4 + n] = rng.integers(0, 5000, n)
    hidden = rng.standard_normal((3, 10, D)).astype(np.float32)
    return hidden, tokens


def test_losses_and_grads_match_jax(models):
    heads = _heads(3, seed=8)
    hidden, tokens = _train_batch()
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda mp: jax_medusa.medusa_losses(mp, models["jt"], JCFG,
                                            jnp.asarray(hidden),
                                            jnp.asarray(tokens), EOT)
    ))(_jax_heads(heads))
    mp = medusa_from_numpy(heads)
    leaves = {k: v.requires_grad_(True) for k, v in flatten_params(mp).items()}
    loss = medusa_losses(mp, models["t"], CFG, torch.from_numpy(hidden),
                         torch.from_numpy(tokens).long(), EOT)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    jflat = {k: np.asarray(v) for k, v in jax_flatten_params(jgrads).items()}
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=0,
                                   atol=1e-5 * max(np.abs(jflat[name]).max(), 1),
                                   err_msg=name)


def test_five_steps_follow_optax_adam(models):
    """train_medusa_step with the heads' Optimizer (no clip, no decay)
    against optax.adam on the same batch: losses and heads step by step."""
    heads = _heads(2, seed=9)
    hidden, tokens = _train_batch()
    tx = optax.adam(1e-2)
    jmp = _jax_heads(heads)
    jstate = tx.init(jmp)
    jstep = jax.jit(lambda mp, st: jax_medusa.train_medusa_step(
        mp, st, tx, models["jt"], JCFG, jnp.asarray(hidden),
        jnp.asarray(tokens), EOT))
    mp = medusa_from_numpy(heads)
    opt = Optimizer(learning_rate=1e-2, max_grad_norm=None, weight_decay=0.0,
                    freeze_encoder=False)
    state = opt.init(flatten_params(mp))
    h, t = torch.from_numpy(hidden), torch.from_numpy(tokens).long()
    for _ in range(5):
        jmp, jstate, jloss = jstep(jmp, jstate)
        mp, state, loss = train_medusa_step(mp, state, opt, models["t"], CFG,
                                            h, t, EOT)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = flatten_params(medusa_to_numpy(mp))
    for name, want in jax_flatten_params(jmp).items():
        np.testing.assert_allclose(got[name], np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_heads_files_load_both_ways(tmp_path):
    heads = _heads(2, seed=3)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "jax.safetensors")
    save_medusa(ours, medusa_from_numpy(heads))
    jax_medusa.save_medusa(theirs, _jax_heads(heads))
    for loaded in (jax_medusa.load_medusa(ours), load_medusa(theirs)):
        for h, want in zip(loaded["heads"], heads["heads"]):
            for k in ("w1", "b1", "w2", "b2"):
                assert np.array_equal(np.asarray(h[k]), want[k])


# -- trees ----------------------------------------------------------------

def test_tree_tables_and_optimize_tree_match_jax(tmp_path):
    from whisper_ipa_tpu.decode.medusa_tree import _tree_tables as jax_tables

    for tree in (DEFAULT_TREE, ((-1, 0), (0, 1), (-1, 1), (1, 0), (2, 0))):
        for a, b in zip(_tree_tables(tree), jax_tables(tree)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(AssertionError):
        _tree_tables(((0, 0), (-1, 0)))
    probs = np.random.default_rng(1).uniform(0.05, 0.9, (4, 4)).tolist()
    for n in (1, 5, 12, 30):
        assert optimize_tree(probs, n) == jax_optimize_tree(probs, n)
    heads = str(tmp_path / "h.safetensors")
    assert tree_for_heads(heads) == jax_tree_for_heads(heads) == DEFAULT_TREE
    with open(heads + ".accuracy.json", "w") as f:
        json.dump({"head_topk_accuracy": probs, "top_c": 4}, f)
    assert tree_for_heads(heads) == jax_tree_for_heads(heads) == jax_optimize_tree(probs, 12)


# -- decoding -------------------------------------------------------------

def _options(cls, cache):
    return cls(language="en", without_timestamps=True, sample_len=12,
               kv_int8=cache == "int8")


def _assert_same(got, gstats, want, wstats):
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    for a, b in zip(got, want):
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-6)
    assert (gstats.rounds, gstats.emitted_tokens, gstats.draft_k) == (
        wstats.rounds, wstats.emitted_tokens, wstats.draft_k)


@pytest.mark.parametrize("cache", ["float", "int8"])
def test_medusa_chain_matches_jax(models, mel, toks, cache):
    heads = _heads(3, seed=11)
    got, gs = speculative_decode(models["t"], CFG, None, None, mel,
                                 _options(DecodingOptions, cache),
                                 tokenizer=toks[0], return_stats=True,
                                 medusa_params=medusa_from_numpy(heads))
    want, ws = jax_spec(models["jt"], JCFG, None, None, jnp.asarray(mel),
                        _options(JaxOptions, cache), tokenizer=toks[1],
                        return_stats=True, medusa_params=_jax_heads(heads))
    _assert_same(got, gs, want, ws)
    assert gs.draft_k == 3
    plain = decode(models["t"], CFG, mel, _options(DecodingOptions, cache),
                   tokenizer=toks[0])
    assert [r.tokens for r in got] == [r.tokens for r in plain]


CUSTOM_TREE = ((-1, 0), (-1, 1), (0, 0), (0, 1), (2, 0), (2, 1), (1, 0))


@pytest.mark.parametrize("tree,cache", [
    (DEFAULT_TREE, "float"),
    (DEFAULT_TREE, "int8"),
    (CUSTOM_TREE, "float"),
])
def test_medusa_tree_matches_jax(models, mel, toks, tree, cache):
    heads = _heads(4, seed=12)
    got, gs = medusa_tree_decode(models["t"], CFG, medusa_from_numpy(heads), mel,
                                 _options(DecodingOptions, cache), tree=tree,
                                 tokenizer=toks[0], return_stats=True)
    want, ws = jax_tree_decode(models["jt"], JCFG, _jax_heads(heads),
                               jnp.asarray(mel), _options(JaxOptions, cache),
                               tree=tree, tokenizer=toks[1], return_stats=True)
    _assert_same(got, gs, want, ws)
    plain = decode(models["t"], CFG, mel, _options(DecodingOptions, cache),
                   tokenizer=toks[0])
    assert [r.tokens for r in got] == [r.tokens for r in plain]


def test_tree_deeper_than_heads_rejected(models, mel):
    with pytest.raises(ValueError, match="exceeds the 3 trained heads"):
        medusa_tree_decode(models["t"], CFG, medusa_from_numpy(_heads(3, 0)), mel,
                           _options(DecodingOptions, "float"))
    with pytest.raises(ValueError, match="temperature"):
        medusa_tree_decode(models["t"], CFG, medusa_from_numpy(_heads(4, 0)), mel,
                           replace(_options(DecodingOptions, "float"),
                                   temperature=0.5))


def test_service_medusa_texts_equal_plain(toks):
    """Full 30 s windows through the service with Medusa heads, chain and
    tree, and plainly: the same texts and avg_logprobs."""
    from whisper_ipa_torch.models import init_params

    cfg = replace(CONFIGS["test-tiny"], n_text_ctx=48)
    params = init_params(cfg, seed=0)
    heads = medusa_from_numpy(_heads(4, seed=13))
    rng = np.random.default_rng(10)
    clips = [(0.1 * rng.standard_normal(int(s * SAMPLE_RATE))).astype(np.float32)
             for s in (4.0, 9.0)]
    outs = {}
    for name, kw in (("plain", {}), ("chain", dict(medusa_params=heads)),
                     ("tree", dict(medusa_params=heads,
                                   medusa_tree=DEFAULT_TREE))):
        svc = TranscriptionService(params, cfg, device="cpu", batch_size=2,
                                   max_wait_ms=2000.0, bf16=False,
                                   tokenizer=toks[0], **kw)
        try:
            outs[name] = [f.result(timeout=300)
                          for f in [svc.submit(c) for c in clips]]
        finally:
            svc.close()
    for name in ("chain", "tree"):
        for a, b in zip(outs[name], outs["plain"]):
            assert a["text"] == b["text"]
            assert a["segments"][0]["avg_logprob"] == pytest.approx(
                b["segments"][0]["avg_logprob"], abs=1e-5)
