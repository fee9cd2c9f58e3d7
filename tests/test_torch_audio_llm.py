"""PyTorch port: the audio language model (``models.audio_llm``,
Uni-MoE-2.0-Omni's path from speech to text) against its plain float32
reference (``whisper_ipa_torch.reference.uni_moe_omni``), at a tiny size
on the CPU: hidden 64, 2 layers, 4 query and 2 K/V heads, routed experts
of width 32, two shared experts of width 16, one null expert, a vocabulary
of 512, seeded random weights.

The last test replays the decode step as a CUDA graph and is marked
``cuda``: it skips without a card.
"""

import ast
import math
from dataclasses import replace
from pathlib import Path
from unittest import mock

import pytest
import torch

from whisper_ipa_torch.config import AUDIO_LLM_CONFIGS, AudioLLMConfig, get_config
from whisper_ipa_torch.decode import DecodingOptions, decode
from whisper_ipa_torch.decode import decoding
from whisper_ipa_torch.models import audio_llm, layers
from whisper_ipa_torch.reference import uni_moe_omni as ref
from whisper_ipa_torch.utils import timing

torch.set_num_threads(1)

CFG = AUDIO_LLM_CONFIGS["test-tiny-omni"]
N_PRE, N_POST, SAMPLE_LEN = 3, 2, 6


@pytest.fixture(scope="module")
def params():
    return audio_llm.init_params(CFG, seed=0, dtype=torch.float32)


@pytest.fixture(scope="module")
def mel():
    gen = torch.Generator().manual_seed(1)
    return torch.randn((3, 3000, CFG.n_mels), generator=gen)


def _options(fp16=False, sample_len=SAMPLE_LEN):
    """Greedy over the ids below the special ones: every row decodes
    ``sample_len`` tokens."""
    return DecodingOptions(prompt=[5, 17, 3], prefix=[41, 9], fp16=fp16,
                           sample_len=sample_len,
                           suppress_tokens=list(range(CFG.first_special, CFG.n_vocab)))


def _probe(p):
    """Router inputs whose float32 softmax is ``p`` (N, n_slots): n = log p
    through an identity gate."""
    p = torch.tensor(p, dtype=torch.float32)
    return torch.log(p), torch.eye(p.shape[1])


def test_the_configuration_resolves():
    cfg = get_config("uni-moe-2.0-omni")
    assert isinstance(cfg, AudioLLMConfig) and get_config("HIT-TMG/Uni-MoE-2.0-Omni") is cfg
    assert (cfg.n_layer, cfg.d_model, cfg.n_head, cfg.n_kv_head, cfg.head_dim) == \
        (28, 3584, 28, 4, 128)
    assert (cfg.n_shared, cfg.shared_ffn, cfg.n_routed, cfg.routed_ffn, cfg.n_null) == \
        (2, 2368, 4, 18944, 1)
    assert cfg.tower == get_config("large-v3") and cfg.n_vocab == 152064
    assert get_config("whisper-small").name == "small"


def test_decode_equals_the_reference_forward(params, mel):
    """Prefill, then the cached greedy decode, in float32: each served
    token is the reference's best allowed token at its position, and the
    program's teacher-forced logits (its prefill and cached steps over the
    served tokens) equal the reference's full forward to 2e-5 (float32
    products in another order: ~1e-6 of logits of ~1), the reference
    following the program's routes only within 1e-4 of a boundary, where
    float32 roundings alone can flip a choice; none is needed here."""
    results = decode(params, CFG, mel, _options())
    served = torch.tensor([r.tokens for r in results])
    assert served.shape == (3, SAMPLE_LEN)
    prompt = torch.tensor([5, 17, 3] + [-1] * CFG.n_audio_tokens + [41, 9]).repeat(3, 1)
    routes = torch.stack([r.routes for r in results], 1)  # (L, B, T_max, K)
    P = prompt.shape[1]
    T = P + SAMPLE_LEN - 1
    assert (routes[:, :, :T] >= 0).all() and (routes[:, :, T:] == -1).all()
    with torch.no_grad():
        want, forced, own = ref.forward(params, CFG, mel, prompt, N_PRE, served[:, :-1],
                                        taken=routes[:, :, :T], eps=1e-4)
        got, _ = audio_llm.forward(params, CFG, prompt, N_PRE,
                                   audio_llm.encode_audio(params, CFG, mel, torch.float32),
                                   served[:, :-1])
    assert forced == 0 and torch.equal(own.to(torch.int8), routes[:, :, :T])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    allowed = want[:, P - 1:, :CFG.first_special]
    assert torch.equal(allowed.argmax(-1), served)
    lp = torch.log_softmax(allowed, -1).gather(-1, served[..., None])[..., 0]
    for r, row in zip(results, lp):
        assert r.avg_logprob == pytest.approx(float(row.sum()) / (SAMPLE_LEN + 1), abs=1e-5)


def test_bfloat16_decode_stays_near_the_reference(mel):
    """The stored bfloat16 model in bfloat16: the served tokens' reference
    logits lie within 0.05 of the best allowed one (bf16 keeps ~3 digits
    through 2 layers; the float8 reference misses by more in
    ``benchmark/tests``' readings)."""
    params = audio_llm.init_params(CFG, seed=0)
    results = decode(params, CFG, mel, _options(fp16=True))
    served = torch.tensor([r.tokens for r in results])
    prompt = torch.tensor([5, 17, 3] + [-1] * CFG.n_audio_tokens + [41, 9]).repeat(3, 1)
    T = prompt.shape[1] + SAMPLE_LEN - 1
    routes = torch.stack([r.routes for r in results], 1)[:, :, :T]
    with torch.no_grad():
        want, _, _ = ref.forward(params, CFG, mel, prompt, N_PRE, served[:, :-1],
                                 taken=routes, eps=0.02)
    lg = want[:, prompt.shape[1] - 1:, :CFG.first_special]
    gap = lg.amax(-1) - lg.gather(-1, served[..., None])[..., 0]
    assert float(gap.max()) < 0.05


@pytest.mark.parametrize("p,slots,weights", [
    ([0.80, 0.10, 0.05, 0.03, 0.02], [0, 5], [0.80, 0.0]),  # top >= 0.7: one
    ([0.05, 0.70, 0.10, 0.10, 0.05], [1, 5], [0.70, 0.0]),  # exactly 0.7: one
    ([0.40, 0.05, 0.35, 0.10, 0.10], [0, 2], [0.40, 0.35]),  # not renormalised
    ([0.30, 0.10, 0.30, 0.20, 0.10], [0, 2], [0.30, 0.30]),  # capped at 2, tie: lower first
    ([0.10, 0.05, 0.05, 0.05, 0.75], [4, 5], [0.75, 0.0]),  # the null expert alone
])
def test_capped_top_p_choice(p, slots, weights):
    n, gate = _probe([p])
    r = audio_llm.route(n, gate, CFG)
    assert r.slots.tolist() == [slots]
    torch.testing.assert_close(r.weights, torch.tensor([weights]), atol=1e-6, rtol=0)
    w, _, own = ref.route(n, gate, CFG)
    assert own.tolist() == [slots]


def test_the_null_expert_adds_exactly_nothing(params):
    """A token routed to the null expert alone gets the shared experts'
    output and nothing else, in both dispatches and in the reference."""
    p = params["layers"][0]
    gen = torch.Generator().manual_seed(3)
    n = torch.randn((4, CFG.d_model), generator=gen)
    r = audio_llm.Routes(torch.tensor([[4, 5]] * 4), torch.tensor([[0.75, 0.0]] * 4))
    shared = audio_llm._shared(p, n)
    assert torch.equal(audio_llm.moe_grouped(p, n, r, CFG), shared)
    assert torch.equal(audio_llm.moe_static(p, n, r, CFG), shared)
    w = torch.zeros(4, CFG.n_slots)
    w[:, 4] = 0.75
    with mock.patch.object(ref, "route", return_value=(w, 0, r.slots)):
        y, _, _ = ref.moe(n, p, CFG)
    torch.testing.assert_close(y, shared, atol=1e-6, rtol=0)


def test_the_static_decode_moe_equals_the_grouped_prefill_moe(params):
    """The same 40 tokens through both dispatches, routed by the model's
    own gate: equal to 1e-6 (the same products and sums, in float32, over
    gathered rows or all rows: a BLAS may block them differently)."""
    p = params["layers"][1]
    gen = torch.Generator().manual_seed(4)
    n = torch.randn((40, CFG.d_model), generator=gen)
    r = audio_llm.route(n, p["router"], CFG)
    assert (r.slots[:, 1] == CFG.n_slots).any() and (r.slots[:, 1] < CFG.n_slots).any()
    torch.testing.assert_close(audio_llm.moe_static(p, n, r, CFG),
                               audio_llm.moe_grouped(p, n, r, CFG), atol=1e-6, rtol=0)


def test_rope_with_three_equal_mrope_sections_is_1d_rope():
    """Qwen2-VL's multimodal RoPE, its head split into sections [16, 24,
    24] of frequencies that take the temporal, height and width ids: with
    the three ids equal it is rotate-half RoPE at that id."""
    Dh, T = 128, 11
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 3, T, Dh), generator=gen)
    cos, sin = layers.rope_tables(T, Dh, 1e6)
    ids = torch.arange(T)
    inv = 1e6 ** (-torch.arange(0, Dh, 2, dtype=torch.float64) / Dh)
    per_axis = [ids[:, None].double() * inv[None, :] for _ in range(3)]  # t = h = w
    chunks, start = [], 0
    for axis, width in enumerate([16, 24, 24]):
        chunks.append(per_axis[axis][:, start:start + width])
        start += width
    ang = torch.cat(chunks, -1)
    ang = torch.cat([ang, ang], -1)
    mcos, msin = torch.cos(ang).float(), torch.sin(ang).float()
    torch.testing.assert_close(layers.apply_rope(x, mcos, msin),
                               layers.apply_rope(x, cos, sin), atol=0, rtol=0)
    torch.testing.assert_close(layers.apply_rope(x, cos, sin), ref.rope(x, 1e6),
                               atol=1e-6, rtol=0)


def test_gqa_equals_attention_with_the_kv_heads_repeated():
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((2, 8, 5, 16), generator=gen)
    k = torch.randn((2, 2, 5, 16), generator=gen)
    v = torch.randn((2, 2, 5, 16), generator=gen)
    mask = torch.full((5, 5), float("-inf")).triu(1)
    got = layers.gqa_attention(q, k, v, mask)
    kr, vr = k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1)
    want = torch.softmax(q @ kr.transpose(-1, -2) / 4.0 + mask, -1) @ vr
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def _imports(path):
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_neither_the_kernels_nor_jax():
    names = set(_imports(ref.__file__))
    assert names <= {"__future__", "math", "typing", "torch", "torch.nn.functional"}, names
    assert not any("ops" in n or "jax" in n or "whisper_ipa" in n for n in names)


def test_decode_runs_the_shared_greedy_loop(params, mel):
    """``decode`` hands the audio language model to the same
    ``_greedy_decode`` as Whisper, with the model's own steps; the
    suppressed ids never appear; beam search is refused."""
    real, calls = decoding._greedy_decode, []

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    with mock.patch.object(decoding, "_greedy_decode", side_effect=spy):
        results = decode(params, CFG, mel[:1], _options())
    assert len(calls) == 1 and isinstance(calls[0], decoding.DecodeSteps)
    assert all(t < CFG.first_special for t in results[0].tokens)
    assert math.isnan(results[0].no_speech_prob) and results[0].text == ""
    with pytest.raises(ValueError):
        decode(params, CFG, mel[:1], replace(_options(), beam_size=2))


def test_the_routing_counter_counts_only_while_tracing(params, mel):
    """Under ``timing.tracing()`` one record a call: each layer's slot
    counts sum to its routed picks, the prefill's tokens are the prompt's
    rows and the decode's one a row a forward step, expert-GEMM rows are
    the non-null picks in the prefill and every row times every routed
    expert in a decode step, all equal to the routes the call returns;
    spans name the model's parts. Outside it, nothing is recorded."""
    B = 3
    before = len(audio_llm.routing_records())
    decode(params, CFG, mel, _options())
    assert len(audio_llm.routing_records()) == before
    with timing.tracing():
        results = decode(params, CFG, mel, _options())
    recs = timing.records()
    rec = audio_llm.routing_records()[-1]
    call = [r for r in recs if r.name == "decode"][-1]
    assert rec.call == call.id
    names = [r.name for r in recs if r.call == call.id]
    L, S = CFG.n_layer, CFG.n_slots
    assert names.count("llm.connector") == 1 and names.count("llm.prefill") == 1
    assert names.count("llm.prefill.moe") == L and names.count("llm.init_cache") == 1
    assert names.count("llm.decode.moe") == L * (SAMPLE_LEN - 1)  # the CPU loop is eager
    assert "decode.init_cache" not in names
    routes = torch.stack([r.routes for r in results], 1).long()
    P = N_PRE + CFG.n_audio_tokens + N_POST
    for phase, span in ((rec.prefill, slice(0, P)), (rec.decode, slice(P, P + SAMPLE_LEN - 1))):
        for l in range(L):
            picks = routes[l, :, span].reshape(-1)
            want = torch.bincount(picks, minlength=S + 1).tolist()
            assert phase[l][:S + 1] == want
            tokens = B * (span.stop - span.start)
            assert phase[l][S + 2] == tokens
            computed = sum(want[:CFG.n_routed]) if phase is rec.prefill else \
                tokens * CFG.n_routed
            assert phase[l][S + 1] == computed


@pytest.mark.cuda
def test_the_graph_replay_gives_the_eager_tokens():
    """On the card, the tiny model in bfloat16 at batch 16: the loop
    replayed as a CUDA graph serves the eager loop's tokens and
    ``avg_logprob`` exactly, and the routes it records; one capture, a
    replay in every step but the first and the last."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only there")
    dev = torch.device("cuda", 0)
    params = audio_llm.init_params(CFG, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    mel = torch.randn((16, 3000, CFG.n_mels), generator=gen, device=dev)
    out = {}
    for path in ("graph", "eager"):
        with mock.patch.object(decoding, "_graph_path",
                               side_effect=lambda *a, p=path: p == "graph"):
            with timing.tracing():
                res = decode(params, CFG, mel, _options(fp16=True, sample_len=12))
            out[path] = (res, [r.name for r in timing.records()])
    (g, g_names), (e, e_names) = out["graph"], out["eager"]
    assert [r.tokens for r in g] == [r.tokens for r in e]
    assert [r.avg_logprob for r in g] == [r.avg_logprob for r in e]
    assert all(torch.equal(a.routes, b.routes) for a, b in zip(g, e))
    assert g_names.count("decode.capture") == 1 and g_names.count("decode.replay") == 10
    rec_g, rec_e = audio_llm.routing_records()[-2:]
    assert rec_g.decode == rec_e.decode and rec_g.prefill == rec_e.prefill
