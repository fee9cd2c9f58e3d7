"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device, and runs on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda

which builds the kernels with nvcc on first use. ``chip_smoke.py`` runs the
same comparisons at the main path's full shapes.
"""

import ctypes

import pytest
import torch

from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import DecodingOptions, decode
from whisper_ipa_torch.models import init_params, params_to
from whisper_ipa_torch.models.convert import flatten_params
from whisper_ipa_torch.models import layers
from whisper_ipa_torch.models import whisper as whisper_model
from whisper_ipa_torch.models.whisper import _quantize_kv_heads4, cast_decoder_blocks
from whisper_ipa_torch.ops import (
    _build,
    attention_backward,
    attention_backward_plain,
    attention_plain,
    decode_attention_int4_plain,
    decode_attention_plain,
    decode_cross_attention_int4_tminor,
    decode_cross_attention_int8_tminor,
    fused_attention,
    fused_kv_init_int8,
    fused_kv_init_plain,
    int4_matmul,
    int4_matmul_plain,
    int8_matmul,
    int8_matmul_plain,
    log_mel_power,
    log_mel_power_plain,
    sr_quant,
)
from whisper_ipa_torch.ops.kv_init import quantize_kv_heads
from whisper_ipa_torch.ops.quant import (quantize_linear, quantize_linear_int4,
                                         quantize_params)
from whisper_ipa_torch.ops.quant_matmul import int4_uses_split_k
from whisper_ipa_torch.ops.attention import (
    _forward_kernel,
    attention_merged_plain,
    fused_attention_merged,
)
from whisper_ipa_torch.ops.sr_quant import (
    quantize_params_device,
    stochastic_quantize_int8,
    stochastic_quantize_int8_many,
    stochastic_quantize_int8_plain,
)
from whisper_ipa_torch.ops.mel_kernel import normalize, reflect_pad
from whisper_ipa_torch.train import create_train_state, train_chunk, train_step
from whisper_ipa_torch.utils import timing

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize(
    "batch, samples",
    [(2, 48_000 + 37), (1, 16_000), (16, 16_000), (1, 480_000), (16, 480_000)],
)
def test_mel_kernel(dev, batch, samples, n_mels):
    """K1 within 5e-4 of its plain version after normalize, one launch: a
    length that is not a whole frame, and batch 1 and 16 at 1 s (100
    frames, a ragged last frame tile) and 30 s, at 80 and 128 mels."""
    gen = torch.Generator(device=dev).manual_seed(0)
    audio = 0.1 * torch.randn((batch, samples), generator=gen, device=dev)
    padded = reflect_pad(audio).contiguous()
    before = log_mel_power.launches
    got = normalize(log_mel_power(padded, n_mels))
    assert log_mel_power.launches == before + 1
    want = normalize(log_mel_power_plain(padded, n_mels))
    assert got.shape == (batch, samples // 160, n_mels)
    assert (got - want).abs().max().item() < 5e-4


# query and key counts at every tile edge of the kernels: one row, one
# short of a 64-row tile, one past it, and the encoder's 1500
EDGES = [(tq, tk) for tq in (1, 63, 1500) for tk in (1, 65, 1500)]


def _bf16_close(got, want, atol=5e-3) -> bool:
    """Every element within atol, or within one bf16 ulp of the plain value
    where that is larger: an output at or above 1 in magnitude whose fp32
    sums round to the neighbouring bf16 value is 2^-7 off."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((got.float() - w).abs() <= ulp.clamp_min(atol)).all())


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk", [(128, 128), (256, 300), (130, 257)] + EDGES)
def test_attention_kernel(dev, tq, tk, dh, dtype, atol):
    """K2 against its plain version: f32 2e-5 (the TPU kernel's test
    bound); bf16 5e-3 absolute, or one bf16 ulp of outputs at or above 1
    (both sides sum in f32 and round P to bf16 before the value product, at
    values that differ in the last bits)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (
        torch.randn((2, 3, t, dh), generator=gen, device=dev).to(dtype)
        for t in (tq, tk, tk)
    )
    before = fused_attention.launches
    got = fused_attention(q, k, v, dh ** -0.5)
    assert fused_attention.launches == before + 1
    want = attention_plain(q, k, v, dh ** -0.5)
    if dtype == torch.bfloat16:
        assert _bf16_close(got, want, atol)
    else:
        assert (got.float() - want.float()).abs().max().item() < atol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,t_pad,t", [(32, 128, 32), (64, 1536, 1500)])
def test_decode_attention_kernel(dev, dtype, dh, t_pad, t):
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H = 3, 5

    def codes():
        c = torch.randint(-127, 128, (B, H, dh, t_pad), generator=gen, device=dev)
        return c.to(torch.int8)

    def scales():
        s = 0.01 + 0.02 * torch.rand((B, H, t_pad), generator=gen, device=dev)
        s[..., t:] = 0.0
        return s

    k, ks, v, vs = codes(), scales(), codes(), scales()
    q = (torch.randn((B, H, 1, dh), generator=gen, device=dev) * dh ** -0.5).to(dtype)
    before = decode_cross_attention_int8_tminor.launches
    got = decode_cross_attention_int8_tminor(q, k, ks, v, vs)
    assert decode_cross_attention_int8_tminor.launches == before + 1
    want = decode_attention_plain(q, k, ks, v, vs)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 0.02 * scale


def _device_kernels(fn, iters: int = 10) -> dict:
    """{device kernel name: launches} over iters fn() calls, from
    torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _assert_one_kernel(fn, name: str, iters: int = 10):
    """Every device kernel of the calls is ``name``'s, at most one a call.
    (The profiler may miss a launch of a microsecond-scale kernel inside a
    long test session, so the count is held to at most, not exactly, one
    a call; chip_smoke.py reads exactly one over 50 calls.)"""
    kernels = _device_kernels(fn, iters)
    assert kernels and all(name in k for k in kernels), kernels
    assert 0 < sum(kernels.values()) <= iters, kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("t_pad,t", [(128, 100), (1536, 1500)])
@pytest.mark.parametrize("B,H", [(1, 1), (1, 12), (16, 12)])
def test_decode_attention_cluster_shapes(dev, B, H, t_pad, t, dh, dtype):
    """K4's one-launch cluster design at B * H 1, 12 and 192, T_pad 128 (2
    slices, the second partly padding) and 1536 (8 slices of 192), with
    padded tails: one wrapper launch a call, f32 rtol = atol = 1e-5, bf16 q
    2% of max|out|."""
    gen = torch.Generator(device=dev).manual_seed(B * H + t_pad + dh)
    k, v = (torch.randint(-127, 128, (B, H, dh, t_pad), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
    ks, vs = (0.01 + 0.02 * torch.rand((B, H, t_pad), generator=gen, device=dev)
              for _ in range(2))
    ks[..., t:] = 0.0
    vs[..., t:] = 0.0
    q = (torch.randn((B, H, 1, dh), generator=gen, device=dev) * dh ** -0.5).to(dtype)
    before = decode_cross_attention_int8_tminor.launches
    got = decode_cross_attention_int8_tminor(q, k, ks, v, vs)
    assert decode_cross_attention_int8_tminor.launches == before + 1
    want = decode_attention_plain(q, k, ks, v, vs)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= 0.02 * scale


@pytest.mark.parametrize("t_pad", [128, 1536])
def test_decode_attention_one_kernel_a_call(dev, t_pad):
    """K4 is one device kernel a call (no merge pass), and allocates no
    scratch beyond its output."""
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, dh = 16, 12, 64
    k, v = (torch.randint(-127, 128, (B, H, dh, t_pad), generator=gen,
                          device=dev).to(torch.int8) for _ in range(2))
    ks, vs = (0.01 + 0.02 * torch.rand((B, H, t_pad), generator=gen, device=dev)
              for _ in range(2))
    q = torch.randn((B, H, 1, dh), generator=gen, device=dev).to(torch.bfloat16)
    call = lambda: decode_cross_attention_int8_tminor(q, k, ks, v, vs)  # noqa: E731
    _assert_one_kernel(call, "decode_int8_cluster_kernel")
    call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = call()
    assert torch.cuda.memory_allocated(dev) - before == out.numel() * out.element_size()


def _grad_err_ok(got, want, tol) -> bool:
    """max|got - want| within tol of max|want|, or within tol absolute where
    the gradient is exactly 0 (one key: softmax's gradient vanishes, so dq
    and dk are 0 and the kernel's are at the level of fp32 cancellation)."""
    top = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() <= tol * (top or 1.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk", [(130, 257), (1100, 300)] + EDGES)
def test_attention_backward_kernel(dev, tq, tk, dh, dtype, tol):
    """K5 against its plain version, relative to max|grad|: f32 1e-4 (another
    summation order than cuBLAS), bf16 1e-2: both sides round P and dS to
    bf16 before their products (one ulp 2^-8 relative) at values that differ
    in the last bits, and sum up to T such terms."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q, g = (torch.randn((2, 3, tq, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    k, v = (torch.randn((2, 3, tk, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    scale = dh ** -0.5
    out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
    before = attention_backward.launches
    got = attention_backward(q, k, v, out, g, lse, scale)
    assert attention_backward.launches == before + 1
    for a, b in zip(got, attention_backward_plain(q, k, v, g, scale)):
        assert a.shape == b.shape and a.dtype == dtype
        assert _grad_err_ok(a, b, tol)


@pytest.mark.parametrize("kernel", ["K2", "K10", "K5"])
def test_attention_misaligned_operand_raises(dev, kernel):
    """The kernels copy 16-byte chunks: a bf16 operand at an odd storage
    offset (contiguous, so ``.contiguous()`` keeps it) raises, and nothing
    is launched or copied."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (1, 2, 70, 64) if kernel != "K10" else (1, 70, 128)
    n = 1
    for d in shape:
        n *= d
    buf = torch.randn((n + 1,), generator=gen, device=dev).to(torch.bfloat16)
    bad = buf[1:].view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    good = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    if kernel == "K5":
        out, lse = _forward_kernel(good, good, good, 0.125, with_lse=True)
    counters = (fused_attention.launches, fused_attention_merged.launches,
                attention_backward.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "K2":
            fused_attention(good, bad, good, 0.125)
        elif kernel == "K10":
            fused_attention_merged(good, good, bad, 2, 0.125)
        else:
            attention_backward(good, good, good, out, bad, lse, 0.125)
    assert (fused_attention.launches, fused_attention_merged.launches,
            attention_backward.launches) == counters


def test_fused_attention_autograd_runs_k5(dev):
    q, k, v = (torch.randn((2, 3, 200, 64), device=dev, requires_grad=True)
               for _ in range(3))
    before = attention_backward.launches
    got = torch.autograd.grad(fused_attention(q, k, v, 0.125).sum(), (q, k, v))
    assert attention_backward.launches == before + 1
    want = torch.autograd.grad(attention_plain(q, k, v, 0.125).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() < 1e-4 * b.abs().max().item()


def test_whisper_small_unfrozen_bf16_train_step(dev):
    """One full fine-tune step at whisper-small width, bf16 activations:
    K2 and K5 run once per encoder layer, the loss is finite and every
    encoder weight moves."""
    cfg = CONFIGS["small"]
    params = init_params(cfg, seed=0, device=dev)
    before = {n: t.clone() for n, t in flatten_params(params).items()
              if n.startswith("encoder.")}
    state, tx = create_train_state(params, learning_rate=1e-4,
                                   freeze_encoder=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    mel = torch.randn((2, 3000, cfg.n_mels), generator=gen, device=dev)
    tokens = torch.full((2, 32), 50257, device=dev, dtype=torch.long)
    tokens[:, :20] = torch.randint(0, 50000, (2, 20), generator=gen, device=dev)
    k2, k5 = fused_attention.launches, attention_backward.launches
    state, loss = train_step(state, mel, tokens, cfg, tx, 50257,
                             freeze_encoder=False, dtype_name="bfloat16")
    assert fused_attention.launches - k2 == cfg.n_audio_layer
    assert attention_backward.launches - k5 == cfg.n_audio_layer
    assert torch.isfinite(loss).item()
    after = flatten_params(state.params)
    assert all(not torch.equal(after[n], t) for n, t in before.items()
               if n.endswith(".w"))


@pytest.mark.parametrize("freeze", [True, False])
def test_train_chunk_is_sync_free(dev, freeze):
    """A chunk of 3 whisper-tiny steps (bf16, K2 forward; with the encoder
    unfrozen K5 backward too) calls nothing that synchronizes the host:
    sync-debug "error" raises at any such call. Its losses equal three
    train_step calls from the same state, bit for bit."""
    cfg = CONFIGS["tiny"]
    gen = torch.Generator(device=dev).manual_seed(0)
    mels = torch.randn((3, 2, 3000, cfg.n_mels), generator=gen, device=dev)
    tokens = torch.full((3, 2, 16), 50257, device=dev, dtype=torch.long)
    tokens[:, :, :10] = torch.randint(0, 50000, (3, 2, 10), generator=gen,
                                      device=dev)
    kw = dict(freeze_encoder=freeze, dtype_name="bfloat16")
    runs = []
    for chunked in (False, True):
        state, tx = create_train_state(init_params(cfg, seed=0, device=dev),
                                       learning_rate=1e-4,
                                       freeze_encoder=freeze)
        train_step(state, mels[0], tokens[0], cfg, tx, 50257, **kw)  # warm
        torch.cuda.synchronize()
        if chunked:
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, losses = train_chunk(state, mels, tokens, cfg, tx,
                                            50257, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            losses = torch.stack([
                train_step(state, m, t, cfg, tx, 50257, **kw)[1]
                for m, t in zip(mels, tokens)])
        runs.append(losses)
    assert torch.equal(runs[0], runs[1])  # K5 sums without atomics


def test_spans_leave_the_device_timeline_alone(dev):
    """A whisper-tiny decode (bf16, int8 cache, K4) under the profiler,
    host and device: no device-side event is a span marker or a mirror of
    one, and every span's stream interval lies inside its ``decode``'s,
    the children's sum within it. A chunk of 3 training steps inside
    ``timing.tracing()`` records its spans with no host sync (sync-debug
    "error"), each with a stream time."""
    cfg = CONFIGS["tiny"]
    params = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((4, cfg.n_audio_ctx, cfg.n_audio_state), generator=gen,
                        device=dev).to(torch.bfloat16)
    opts = DecodingOptions(language="en", without_timestamps=True, fp16=True,
                           kv_int8=True, sample_len=16, suppress_blank=False,
                           suppress_tokens=list(range(50257, cfg.n_vocab)))
    decode(params, cfg, feats, opts)  # warm: kernel builds
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decode(params, cfg, feats, opts)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_device) > 100
    assert not [e.name for e in on_device if timing.parse_marker(e.name)]
    recs = timing.records()
    root = recs[0]
    # cast, cache, prefix; the capture, 16 steps, 14 of them replays; one
    # finished check; the read-back
    assert root.name == "decode" and len(recs) == 1 + 3 + 1 + 16 + 14 + 1 + 1
    for r in recs[1:]:
        assert 0 <= r.stream_ms
        assert root.stream_start_ms <= r.stream_start_ms <= r.stream_end_ms <= root.stream_end_ms
    assert sum(r.stream_ms for r in recs if r.parent == root.id) <= root.stream_ms

    gen = torch.Generator(device=dev).manual_seed(1)
    mels = torch.randn((3, 2, 3000, cfg.n_mels), generator=gen, device=dev)
    tokens = torch.full((3, 2, 16), 50257, device=dev, dtype=torch.long)
    tokens[:, :, :10] = torch.randint(0, 50000, (3, 2, 10), generator=gen, device=dev)
    state, tx = create_train_state(params, learning_rate=1e-4)
    kw = dict(freeze_encoder=True, dtype_name="bfloat16")
    train_step(state, mels[0], tokens[0], cfg, tx, 50257, **kw)  # warm
    torch.cuda.synchronize()
    with timing.tracing():
        torch.cuda.set_sync_debug_mode("error")
        try:
            train_chunk(state, mels, tokens, cfg, tx, 50257, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    recs = timing.records()
    assert [r.name for r in recs] == ["train.step", "train.forward", "train.backward",
                                      "train.optimizer"] * 3
    assert all(r.stream_ms > 0 for r in recs)


# -- the decode loop's CUDA graph ------------------------------------------


@pytest.fixture(scope="module")
def tiny_on_card():
    """whisper-tiny (4 decoder layers, head width 64) on the card and 512
    windows of bf16 encoder output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph path runs only there")
    dev = torch.device("cuda", 0)
    cfg = CONFIGS["tiny"]
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((512, cfg.n_audio_ctx, cfg.n_audio_state), generator=gen,
                        device=dev).to(torch.bfloat16)
    return cfg, init_params(cfg, seed=0, device=dev), feats


def _decode_on(path, params, cfg, feats, opts):
    """``decode`` on the graph path or, with the choice forced off, on the
    eager path: (results, span names, launches each counted kernel made)."""
    from unittest import mock

    from whisper_ipa_torch.decode import decoding

    before = [fn.launches for fn in decoding._COUNTED_KERNELS]
    with mock.patch.object(decoding, "_graph_path",
                           side_effect=lambda *a: path == "graph"):
        with timing.tracing():
            res = decode(params, cfg, feats, opts)
    names = [r.name for r in timing.records()]
    return res, names, [fn.launches - b for fn, b in
                        zip(decoding._COUNTED_KERNELS, before)]


@pytest.mark.parametrize("sample_len", [8, 64])
@pytest.mark.parametrize("batch", [512, 7])
@pytest.mark.parametrize("timestamps", [False, True])
@pytest.mark.parametrize("cache", ["float", "int8", "int4"])
def test_graph_loop_equals_the_eager_loop(tiny_on_card, cache, timestamps, batch,
                                          sample_len):
    """whisper-tiny in bf16, each cross cache, with and without the
    timestamp grammar, at batch 512 and 7: the loop replayed as a CUDA
    graph gives the eager loop's tokens, ``avg_logprob`` (the summed
    log-probabilities over one length) and ``no_speech_prob`` exactly, and
    every kernel counter (K4 with the int8 cache, K8 with int4) counts
    what the eager loop counts. One ``decode.capture`` a call and a
    ``decode.replay`` in every step but the first and the last."""
    cfg, params, feats = tiny_on_card
    kw = dict(language="en", fp16=True, sample_len=sample_len,
              kv_int8=cache == "int8", kv_int4=cache == "int4")
    if timestamps:
        opts = DecodingOptions(without_timestamps=False, **kw)
    else:  # every row decodes sample_len text tokens
        opts = DecodingOptions(without_timestamps=True, suppress_blank=False,
                               suppress_tokens=list(range(50257, cfg.n_vocab)), **kw)
    feats = feats[:batch]
    graph, g_names, g_launches = _decode_on("graph", params, cfg, feats, opts)
    eager, e_names, e_launches = _decode_on("eager", params, cfg, feats, opts)
    assert [r.tokens for r in graph] == [r.tokens for r in eager]
    assert [r.avg_logprob for r in graph] == [r.avg_logprob for r in eager]
    assert [r.no_speech_prob for r in graph] == [r.no_speech_prob for r in eager]
    assert g_launches == e_launches
    k4, k8 = g_launches[0], g_launches[1]
    steps = g_names.count("decode.step")
    assert steps == e_names.count("decode.step")
    if not timestamps:
        assert steps == sample_len
    assert (k4 > 0) == (cache == "int8") and (k8 > 0) == (cache == "int4")
    assert g_names.count("decode.capture") == 1
    assert g_names.count("decode.replay") == steps - 2
    assert "decode.capture" not in e_names and "decode.replay" not in e_names


def test_graph_kernels_reach_the_profiler(tiny_on_card, monkeypatch):
    """Two graph-path decodes under the profiler (host and device), from a
    fresh record of side streams and graphs: K4's kernel appears once a
    decoder layer for every forward of the loop, the replayed ones
    included, so the benchmark's kernel metrics still see the loop; the
    first capture adds one warm-up iteration on its new side stream, the
    second none. No span marker reaches the device's timeline."""
    import threading

    from whisper_ipa_torch.decode import decoding

    cfg, params, feats = tiny_on_card
    opts = DecodingOptions(language="en", without_timestamps=True, fp16=True,
                           kv_int8=True, sample_len=16, suppress_blank=False,
                           suppress_tokens=list(range(50257, cfg.n_vocab)))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    monkeypatch.setattr(decoding, "_GRAPHS", threading.local())
    seen = []
    for _ in range(2):
        with torch.profiler.profile(activities=acts) as prof:
            decode(params, cfg, feats[:64], opts)
            torch.cuda.synchronize()
        on_device = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        recs = timing.records()  # two profiler runs share one recording
        last = [r for r in recs if r.name == "decode"][-1]
        names = [r.name for r in recs if r.call == last.id]
        seen.append((sum("decode_int8_cluster_kernel" in n for n in on_device),
                     names.count("decode.capture"), names.count("decode.replay"),
                     [n for n in on_device if timing.parse_marker(n)]))
    L = cfg.n_text_layer
    assert seen == [(L * 16, 1, 14, []), (L * 15, 1, 14, [])]


def test_graph_pool_is_reused_across_calls(tiny_on_card):
    """Each call captures its own graph into the pool of the thread's
    last one, so repeated decodes reserve no more memory than two did;
    a graph whose pool were left behind a call would add its step's
    transients (the (512, n_vocab) f32 logits and their kin) every call."""
    cfg, params, feats = tiny_on_card
    opts = DecodingOptions(language="en", without_timestamps=True, fp16=True,
                           kv_int8=True, sample_len=8, suppress_blank=False,
                           suppress_tokens=list(range(50257, cfg.n_vocab)))
    first = [decode(params, cfg, feats, opts) for _ in range(2)]
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    later = [decode(params, cfg, feats, opts) for _ in range(4)]
    torch.cuda.synchronize()
    logits_bytes = feats.shape[0] * cfg.n_vocab * 4
    assert torch.cuda.memory_reserved() - reserved < logits_bytes
    assert all([r.tokens for r in res] == [r.tokens for r in first[0]]
               for res in first[1:] + later)


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 37, 64, 1000, 24000])
def test_int8_matmul_kernel(dev, m, k, n, dtype):
    """K6 against its plain version, bit for bit: the same codes and scales
    (IEEE divisions), integer sums exact in any order and split, the same
    f32 rescale. Rows up to 64 take the split-K body, more the tiles; 17,
    37 and 1000 leave partial 16-row and 128-row tiles."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = quantize_linear({"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
    w_q, w_s = q["w_q"].to(dev), q["w_s"].to(dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    x[0] = 0.0  # an all-zero row: scale floor 1e-6 / 127
    before = int8_matmul.launches
    got = int8_matmul(x, w_q, w_s)
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, int8_matmul_plain(x, w_q, w_s))


@pytest.mark.parametrize("m", [5, 64, 200])
def test_int8_matmul_ragged_shapes(dev, m):
    """K not a multiple of the 128-code tile or the 32-code slice, N not of
    16 (the byte loads), x a (B, T, K) batch: still bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(1)
    k, n = 388, 200
    q = quantize_linear({"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
    w_q, w_s = q["w_q"].to(dev), q["w_s"].to(dev)
    x = torch.randn((1, m, k), generator=gen, device=dev).to(torch.bfloat16)
    assert torch.equal(int8_matmul(x, w_q, w_s), int8_matmul_plain(x, w_q, w_s))


def test_int8_activations_tokens_through_k6(dev, monkeypatch):
    """test-tiny greedy tokens under use_int8_activations on the card: the
    ones that run K6 (on the graph path) equal the ones with K6 replaced by
    its plain version, which runs on the eager loop: its IEEE division
    copies the divisor from the host, which a graph capture cannot hold."""
    from whisper_ipa_torch.decode import decoding
    from dataclasses import replace

    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.models import params_to
    from whisper_ipa_torch.ops.quant import quantize_params
    from whisper_ipa_torch.tokenizer import get_tokenizer

    cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=150, n_text_ctx=48)
    params = params_to(quantize_params(init_params(cfg, seed=0), bits=8), dev)
    mel = torch.randn((2, 300, cfg.n_mels), generator=torch.Generator().manual_seed(0))
    opts = DecodingOptions(language="en", without_timestamps=True,
                           sample_len=16, kv_int8=True)
    tok = get_tokenizer(multilingual=True, language="en")
    layers.use_int8_activations(True)
    try:
        before = int8_matmul.launches
        kernel = decode(params, cfg, mel, opts, tokenizer=tok)
        assert int8_matmul.launches > before
        monkeypatch.setattr(layers, "int8_matmul", int8_matmul_plain)
        monkeypatch.setattr(decoding, "_graph_path", lambda *a: False)
        plain = decode(params, cfg, mel, opts, tokenizer=tok)
    finally:
        layers.use_int8_activations(False)
    assert [r.tokens for r in kernel] == [r.tokens for r in plain]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(16, 768, 3072), (64, 3072, 768), (5, 128, 200)])
def test_int4_matmul_kernel(dev, m, k, n, dtype):
    """K7 against its plain version, relative 1e-5 of max|y| (f32 sums in
    another order)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = quantize_linear_int4(
        {"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
    w_q4, w_s4 = q["w_q4"].to(dev), q["w_s4"].to(dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    before = int4_matmul.launches
    got = int4_matmul(x, w_q4, w_s4)
    assert int4_matmul.launches == before + 1
    assert _rel(got, int4_matmul_plain(x, w_q4, w_s4)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(128, 200), (768, 768), (768, 3072), (3072, 768),
                                 (3072, 200)])
@pytest.mark.parametrize("m", [1, 16, 48, 64, 65])
def test_int4_matmul_bodies(dev, m, k, n, dtype):
    """K7's split-K body at M 1-64 and the warps-split body at M 65, with a
    ragged N (200: byte copies of the weights, a partial 32-column tile)
    and K 128-3072: one wrapper launch a call, relative 1e-5 of max|y|."""
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    q = quantize_linear_int4(
        {"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
    w_q4, w_s4 = q["w_q4"].to(dev), q["w_s4"].to(dev)
    rows_per_group = w_q4.shape[0] // w_s4.shape[0]
    x_bytes = 2 if dtype == torch.bfloat16 else 4
    assert int4_uses_split_k(m, k, n, rows_per_group, x_bytes) == (m <= 64)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    before = int4_matmul.launches
    got = int4_matmul(x, w_q4, w_s4)
    assert int4_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got, int4_matmul_plain(x, w_q4, w_s4)) <= 1e-5


@pytest.mark.parametrize("m,k,n", [(16, 768, 3072), (16, 3072, 768), (48, 768, 768)])
def test_int4_matmul_one_kernel_a_call(dev, m, k, n):
    """K7 at the decode and prefix shapes is one device kernel a call."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q = quantize_linear_int4(
        {"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
    w_q4, w_s4 = q["w_q4"].to(dev), q["w_s4"].to(dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    _assert_one_kernel(lambda: int4_matmul(x, w_q4, w_s4), "int4_matmul_split_k")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_unaligned_x(dev, dtype):
    """x not 16-byte aligned (a view one element in): the split-K body
    copies it element by element, with the same result."""
    gen = torch.Generator(device=dev).manual_seed(3)
    m, k, n = 16, 768, 768
    q = quantize_linear_int4(
        {"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
    w_q4, w_s4 = q["w_q4"].to(dev), q["w_s4"].to(dev)
    flat = torch.randn((m * k + 1,), generator=gen, device=dev).to(dtype)
    x = flat[1:].view(m, k)
    assert x.data_ptr() % 16
    assert _rel(int4_matmul(x, w_q4, w_s4), int4_matmul_plain(x, w_q4, w_s4)) <= 1e-5


def test_quantized_linear_routes(dev):
    """On CUDA a decode-shaped int4 linear runs K7 and an encoder-shaped one
    the half-weight path; int8 weights run K6 only under the switch."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = 0.05 * torch.randn((768, 768), generator=gen, device=dev)
    q4 = {k: v.to(dev) for k, v in quantize_linear_int4({"w": w}).items()}
    q8 = {k: v.to(dev) for k, v in quantize_linear({"w": w}).items()}
    small = torch.randn((16, 1, 768), generator=gen, device=dev, dtype=torch.bfloat16)
    large = torch.randn((4, 1500, 768), generator=gen, device=dev, dtype=torch.bfloat16)
    k7, k6 = int4_matmul.launches, int8_matmul.launches
    layers.linear(small, q4)
    layers.linear(large, q4)
    assert int4_matmul.launches == k7 + 1
    layers.linear(small, q8)
    assert int8_matmul.launches == k6
    try:
        layers.use_int8_activations(True)
        layers.linear(large, q8)
    finally:
        layers.use_int8_activations(False)
    assert int8_matmul.launches == k6 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,t", [(32, 32), (64, 1500)])
def test_decode_attention_int4_kernel(dev, dtype, dh, t):
    """K8 against its plain version: f32 rtol = atol = 1e-5; bf16 q 1% of
    max|out| (the plain version rounds logits and probabilities to bf16)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H = 3, 5
    kf, vf = (torch.randn((B, t, H * dh), generator=gen, device=dev)
              for _ in range(2))
    k, ks = _quantize_kv_heads4(kf, H)
    v, vs = _quantize_kv_heads4(vf, H)
    q = (torch.randn((B, H, 1, dh), generator=gen, device=dev) * dh ** -0.5).to(dtype)
    before = decode_cross_attention_int4_tminor.launches
    got = decode_cross_attention_int4_tminor(q, k, ks, v, vs)
    assert decode_cross_attention_int4_tminor.launches == before + 1
    want = decode_attention_int4_plain(q, k, ks, v, vs)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got, want) <= 1e-2


def _int4_cache(dev, B, H, dh, t, seed):
    """A cross cache as serving builds it: (B, t, H * dh) values through
    the int4 quantizer, padded to T_pad (scale 0 past t)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kf, vf = (torch.randn((B, t, H * dh), generator=gen, device=dev)
              for _ in range(2))
    k, ks = _quantize_kv_heads4(kf, H)
    v, vs = _quantize_kv_heads4(vf, H)
    q = torch.randn((B, H, 1, dh), generator=gen, device=dev) * dh ** -0.5
    return q, k, ks, v, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("t_pad,t", [(128, 100), (1536, 1500)])
@pytest.mark.parametrize("B,H", [(1, 1), (1, 12), (16, 12)])
def test_decode_attention_int4_cluster_shapes(dev, B, H, t_pad, t, dh, dtype):
    """K8's one-launch cluster design at B * H 1, 12 and 192, T_pad 128 (one
    slice, partly padding) and 1536 (the plan's slices), with padded
    tails: one wrapper launch a call, f32 rtol = atol = 1e-5. bf16 q: the
    kernel works in f32 and rounds its output once, so it is held to the
    f32 reference on q's bf16 values within 2^-8 of max|out| (one bf16
    ulp at the largest output, twice its rounding); and to the bf16 plain
    version within 2% of max|out|, K4's bound: the plain version rounds
    logits and probabilities to bf16, which alone moves it up to 1.3% from
    the f32 reference at B * H 192."""
    q, k, ks, v, vs = _int4_cache(dev, B, H, dh, t, seed=B * H + t_pad + dh)
    assert ks.shape[-1] == t_pad
    q = q.to(dtype)
    before = decode_cross_attention_int4_tminor.launches
    got = decode_cross_attention_int4_tminor(q, k, ks, v, vs)
    assert decode_cross_attention_int4_tminor.launches == before + 1
    want = decode_attention_int4_plain(q, k, ks, v, vs)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        exact = decode_attention_int4_plain(q.float(), k, ks, v, vs)
        assert _rel(got, exact) <= 2.0 ** -8
        assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("t_pad,t", [(128, 100), (1536, 1500)])
def test_decode_attention_int4_one_kernel_a_call(dev, t_pad, t):
    """K8 is one device kernel a call (no merge pass), and allocates no
    scratch beyond its output."""
    q, k, ks, v, vs = _int4_cache(dev, 16, 12, 64, t, seed=1)
    q = q.to(torch.bfloat16)
    call = lambda: decode_cross_attention_int4_tminor(q, k, ks, v, vs)  # noqa: E731
    _assert_one_kernel(call, "decode_int4_cluster_kernel")
    call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = call()
    assert torch.cuda.memory_allocated(dev) - before == out.numel() * out.element_size()


@pytest.mark.parametrize("operand", ["q", "codes", "scales"])
def test_decode_attention_int4_misaligned_operand_raises(dev, operand):
    """K8 copies 16-byte chunks: an operand at an offset that is not 16
    bytes (contiguous, so ``.contiguous()`` keeps it) raises, and nothing
    is launched."""
    q, k, ks, v, vs = _int4_cache(dev, 1, 2, 32, 100, seed=2)

    def shifted(t):
        buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=dev)
        bad = buf[1:].view(t.shape)
        bad.copy_(t)
        assert bad.is_contiguous() and bad.data_ptr() % 16
        return bad

    if operand == "q":
        q = shifted(q)
    elif operand == "codes":
        v = shifted(v)
    else:
        ks = shifted(ks)
    before = decode_cross_attention_int4_tminor.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_cross_attention_int4_tminor(q, k, ks, v, vs)
    assert decode_cross_attention_int4_tminor.launches == before


def _assert_kv_build_close(got, want, T, tol):
    """A K3 build against another: codes >= 99.9% equal, within 1 where
    the (position, head) scale is the same and within 2 where the head's
    maximum itself rounded the other way; scales within ``tol`` relative;
    tail code 0 and scale 0."""
    for i in (0, 2):
        diff = (got[i].int() - want[i].int()).abs()
        same_scale = (got[i + 1] == want[i + 1])[..., None, :]
        assert (diff <= torch.where(same_scale, 1, 2)).all()
        assert (diff == 0).float().mean().item() >= 0.999
        assert (got[i][..., T:] == 0).all()
    for i in (1, 3):
        assert ((got[i] - want[i]).abs() <= tol * want[i].abs()).all()
        assert (got[i][..., T:] == 0).all() and (got[i][..., :T] > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("B,T,d,H", [(2, 150, 64, 2), (2, 1500, 768, 12),
                                     (3, 1500, 384, 6), (64, 1500, 768, 12),
                                     (8, 1500, 1280, 20)])
def test_kv_init_kernel(dev, B, T, d, H, bias, dtype):
    """K3 against its plain version at test-tiny's d 64 (Dh 32),
    whisper-small's 768 (also at batch 64: 4,608 tiles of the bf16 body,
    many waves of its persistent grid), whisper-tiny's 384 and
    whisper-large-v3's 1280 (Dh 64); cuBLAS sums in another order, so a
    bf16 rounding of the projection may fall the other way. Bounds: scales
    within 2^-7 relative in bf16 (one ulp of the head's maximum), 2^-6 in
    bf16 with a bias (one ulp of the projection, then the bias add's own
    rounding: two ulps of a sum that the bias made smaller) and 1e-5 in
    f32; codes >= 99.9% equal, within 1 where the (position, head) scale
    is the same and within 2 where the head's maximum itself rounded the
    other way; tail code 0 and scale 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 0.5 * torch.randn((B, T, d), generator=gen, device=dev)
    wk, wv = (0.05 * torch.randn((d, d), generator=gen, device=dev) for _ in range(2))
    bv = 0.1 * torch.randn((d,), generator=gen, device=dev) if bias else None
    before = fused_kv_init_int8.launches
    got = fused_kv_init_int8(x, wk, None, wv, bv, H, out_dtype=dtype)
    assert fused_kv_init_int8.launches == before + 1
    want = fused_kv_init_plain(x, wk, None, wv, bv, H, dtype)
    tol = (2 ** -6 if bias else 2 ** -7) if dtype == torch.bfloat16 else 1e-5
    _assert_kv_build_close(got, want, T, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_init_writes_into_out_views(dev, dtype):
    """With ``out`` (one layer's views of a stacked cache) K3 writes the
    build there and returns those views: equal, bit for bit, to a build
    into fresh tensors, and the other layers' bytes untouched."""
    B, T, d, H, L = 2, 1500, 384, 6, 3
    gen = torch.Generator(device=dev).manual_seed(1)
    x = (0.5 * torch.randn((B, T, d), generator=gen, device=dev)).to(dtype)
    wk, wv = ((0.05 * torch.randn((d, d), generator=gen, device=dev)).to(dtype)
              for _ in range(2))
    bv = (0.1 * torch.randn((d,), generator=gen, device=dev)).to(dtype)
    codes = [torch.full((L, B, H, 64, 1536), 7, dtype=torch.int8, device=dev)
             for _ in range(2)]
    scales = [torch.full((L, B, H, 1536), -1.0, device=dev) for _ in range(2)]
    out = (codes[0][1], scales[0][1], codes[1][1], scales[1][1])
    got = fused_kv_init_int8(x, wk, None, wv, bv, H, out_dtype=dtype, out=out)
    assert [g.data_ptr() for g in got] == [o.data_ptr() for o in out]
    want = fused_kv_init_int8(x, wk, None, wv, bv, H, out_dtype=dtype)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for t, fill in ((codes[0], 7), (codes[1], 7), (scales[0], -1), (scales[1], -1)):
        assert (t[0] == fill).all() and (t[2] == fill).all()


def _tiny_bf16_params(dev):
    """whisper-tiny's decoder cast to bf16, with a seeded V bias (init_params
    writes zeros) so that the bias path is exercised."""
    params = cast_decoder_blocks(init_params(CONFIGS["tiny"], seed=0, device=dev),
                                 torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(2)
    for blk in params["decoder"]["blocks"]:
        value = blk["cross_attn"]["value"]
        value["b"] = (0.1 * torch.randn(value["b"].shape, generator=gen,
                                        device=dev)).to(torch.bfloat16)
    return params


def test_init_cache_builds_the_int8_cache_with_k3(dev, monkeypatch):
    """On the card in bf16 the int8 cross cache is K3's: one launch a layer,
    each written into the stacked cache (the tensors K3 returns are the
    cache's own layer views, so no stack copy follows), and equal within
    ``test_kv_init_kernel``'s bounds (with a bias) to the unfused build,
    ``linear`` then ``quantize_kv_heads``, of each layer."""
    cfg = CONFIGS["tiny"]
    params = _tiny_bf16_params(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    T = cfg.n_audio_ctx
    feats = (0.5 * torch.randn((3, T, cfg.n_audio_state), generator=gen,
                               device=dev)).to(torch.bfloat16)
    built = []
    real = whisper_model.fused_kv_init_int8
    monkeypatch.setattr(whisper_model, "fused_kv_init_int8",
                        lambda *a, **k: built.append(real(*a, **k)) or built[-1])
    before = fused_kv_init_int8.launches
    cache = whisper_model.init_cache(params, cfg, feats, max_len=8,
                                     dtype=torch.bfloat16, cross_kv_int8=True)
    assert fused_kv_init_int8.launches == before + cfg.n_text_layer
    assert len(built) == cfg.n_text_layer
    H = cfg.n_text_head
    for i, blk in enumerate(params["decoder"]["blocks"]):
        got = (cache.cross_k[i], cache.cross_k_scale[i], cache.cross_v[i],
               cache.cross_v_scale[i])
        assert [t.data_ptr() for t in built[i]] == [t.data_ptr() for t in got]
        want = (*quantize_kv_heads(layers.linear(feats, blk["cross_attn"]["key"]), H),
                *quantize_kv_heads(layers.linear(feats, blk["cross_attn"]["value"]), H))
        _assert_kv_build_close(got, want, T, 2 ** -6)


def test_decode_launches_k3_once_a_layer(tiny_on_card):
    """A greedy ``decode()`` on the card in bf16 with the int8 cache adds
    exactly ``n_text_layer`` launches of K3, on the graph path and the
    eager one."""
    cfg, params, feats = tiny_on_card
    opts = DecodingOptions(language="en", fp16=True, sample_len=8, kv_int8=True,
                           without_timestamps=True)
    for path in ("graph", "eager"):
        before = fused_kv_init_int8.launches
        _decode_on(path, params, cfg, feats[:7], opts)
        assert fused_kv_init_int8.launches == before + cfg.n_text_layer


@pytest.mark.parametrize("build", ["f32 int8", "bf16 int4", "bf16 int8 weights"])
def test_init_cache_leaves_k3_off_other_builds(dev, build):
    """K3 is taken in bf16 with the int8 cache and float weights alone:
    float32 on the card, the int4 cache and int8 weights keep the unfused
    build (with the fused switch off, as by default)."""
    cfg = CONFIGS["tiny"]
    params = _tiny_bf16_params(dev)
    dtype = torch.float32 if build.startswith("f32") else torch.bfloat16
    if build == "bf16 int8 weights":
        params = params_to(quantize_params(params, bits=8), dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    feats = torch.randn((2, cfg.n_audio_ctx, cfg.n_audio_state), generator=gen,
                        device=dev).to(dtype)
    before = fused_kv_init_int8.launches
    cache = whisper_model.init_cache(params, cfg, feats, max_len=8, dtype=dtype,
                                     cross_kv_int8="int4" not in build,
                                     cross_kv_int4="int4" in build)
    torch.cuda.synchronize()
    assert fused_kv_init_int8.launches == before
    assert cache.cross_k_scale is not None


@pytest.mark.parametrize("rows,cols", [(256, 64), (300, 70), (768, 3072), (3072, 768),
                                       (6153, 40)])
def test_sr_quant_kernel(dev, rows, cols):
    """K9 on one weight (the library's table of one) equals its plain
    version bit for bit (the same Philox bits and IEEE divisions), also
    where the slice exceeds the shared-memory stage and is read twice; its
    scales equal the host quantizer's, and the codes stay on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = 0.05 * torch.randn((rows, cols), generator=gen, device=dev)
    w[:, 0] = 0.0  # an all-zero column: scale 1e-8 / 127, codes 0
    before = stochastic_quantize_int8_many.launches
    q, s = stochastic_quantize_int8(w, seed=17)
    assert stochastic_quantize_int8_many.launches == before + 1
    assert q.device == w.device and q.dtype == torch.int8 and s.shape == (cols,)
    pq, ps = stochastic_quantize_int8_plain(w, seed=17)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    host = quantize_linear({"w": w.cpu()})
    assert torch.equal(s[1:].cpu(), host["w_s"][1:])
    assert (q[:, 0] == 0).all()
    assert (q.int().cpu() - host["w_q"].int()).abs().max().item() <= 1
    q2, s2 = stochastic_quantize_int8_many([w], [17])[0]
    assert torch.equal(q2, q) and torch.equal(s2, s)
    _assert_one_kernel(lambda: stochastic_quantize_int8(w, seed=17),
                       "sr_quant_kernel")


def test_sr_quant_geometry(dev):
    """The library's launch geometry is the wrapper's (ops/sr_quant's
    CLUSTER, STRIPS[0], MAX_STAGE, MAX_ENTRIES)."""
    out = (ctypes.c_int * 4)()
    _build.entry("sr_quant", "wipa_sr_quant_geometry", [_build.P])(out)
    assert tuple(out) == (sr_quant.CLUSTER, sr_quant.STRIPS[0],
                          sr_quant.MAX_STAGE, sr_quant.MAX_ENTRIES)


SR_MANY_SHAPES = [(256, 64), (300, 70), (768, 3072), (3072, 768), (5120, 1280),
                  (6153, 40)]


def test_sr_quant_many_kernel(dev):
    """One launch of the grouped K9 over a mixed list (ragged rows and
    columns, whisper-small's and large-v3's tallest shapes, and a weight
    whose slices exceed the shared-memory stage, so it is read twice)
    equals the plain version of each weight bit for bit; the scales equal
    the host quantizer's; an all-zero column gets codes 0; a weight that is
    not 16-byte aligned takes the 4-byte path, as (300, 70) does."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ws = [0.05 * torch.randn(shape, generator=gen, device=dev)
          for shape in SR_MANY_SHAPES]
    ws[1][:, 3] = 0.0
    # contiguous, 4 bytes past a 16-byte boundary
    ws.append(torch.randn((97 * 32 + 1,), generator=gen, device=dev)[1:]
              .view(97, 32))
    seeds = [100 + k for k in range(len(ws))]
    before = stochastic_quantize_int8_many.launches
    out = stochastic_quantize_int8_many(ws, seeds)
    torch.cuda.synchronize()
    assert stochastic_quantize_int8_many.launches == before + 1
    for w, seed, (q, s) in zip(ws, seeds, out):
        pq, ps = stochastic_quantize_int8_plain(w, seed)
        assert torch.equal(q, pq) and torch.equal(s, ps), tuple(w.shape)
        host = quantize_linear({"w": w.cpu()})
        nonzero = (w != 0).any(dim=0).cpu()
        assert torch.equal(s.cpu()[nonzero], host["w_s"][nonzero])
        assert (q.int().cpu() - host["w_q"].int()).abs().max().item() <= 1
    assert (out[1][0][:, 3] == 0).all()
    _assert_one_kernel(lambda: stochastic_quantize_int8_many(ws, seeds),
                       "sr_quant_kernel")


def test_quantize_params_device_one_launch(dev):
    """quantize_params_device on a test-tiny tree is one K9 launch, and
    each weight's codes equal its plain version with its seed."""
    params = init_params(CONFIGS["test-tiny"], seed=0, device=dev)
    before = stochastic_quantize_int8_many.launches
    qp = quantize_params_device(params, seed=7)
    torch.cuda.synchronize()
    assert stochastic_quantize_int8_many.launches == before + 1
    src, dst = flatten_params(params), flatten_params(qp)
    # the reference's visit order: decoder blocks, then encoder blocks
    names = [n[:-2] for side in ("decoder", "encoder") for n, t in src.items()
             if n.startswith(side + ".blocks.") and n.endswith(".w")
             and t.dim() == 2]
    cfg = CONFIGS["test-tiny"]
    assert len(names) == 6 * (cfg.n_audio_layer + cfg.n_text_layer) + (
        4 * cfg.n_text_layer)
    for i, name in enumerate(names):
        q, s = dst[name + ".w_q"], dst[name + ".w_s"]
        assert q.device == dev and q.dtype == torch.int8 and name + ".w" not in dst
        pq, ps = stochastic_quantize_int8_plain(src[name + ".w"], 8 + i)
        assert torch.equal(q, pq) and torch.equal(s, ps), name


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk,h", [(128, 128, 2), (256, 300, 3), (130, 257, 12)])
def test_merged_attention_kernel(dev, tq, tk, h, dh, dtype, atol):
    """K10 against its plain version at K2's bounds, and against K2 on split
    heads bit for bit (one body, one arithmetic order)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (
        torch.randn((2, t, h * dh), generator=gen, device=dev).to(dtype)
        for t in (tq, tk, tk)
    )
    scale = dh ** -0.5
    before = fused_attention_merged.launches
    got = fused_attention_merged(q, k, v, h, scale)
    assert fused_attention_merged.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = attention_merged_plain(q, k, v, h, scale)
    if dtype == torch.bfloat16:
        assert _bf16_close(got, want, atol)
    else:
        assert (got.float() - want.float()).abs().max().item() < atol

    def split(x):
        return layers.split_heads(x, h).contiguous()

    k2 = layers.merge_heads(fused_attention(split(q), split(k), split(v), scale))
    assert torch.equal(got, k2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_merged_attention_autograd_runs_k10_k5(dev, dtype, tol):
    """The Function: K10 forward (with the LSE), K5 backward on split heads;
    gradients against the plain backward, relative to max|grad| as K5's."""
    gen = torch.Generator(device=dev).manual_seed(0)
    h, dh = 3, 64
    q, k, v, g = (
        torch.randn((2, t, h * dh), generator=gen, device=dev).to(dtype)
        for t in (200, 170, 170, 200)
    )
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k10, k5 = fused_attention_merged.launches, attention_backward.launches
    out = fused_attention_merged(*leaves, h, 0.125)
    got = torch.autograd.grad(out, leaves, g)
    assert fused_attention_merged.launches == k10 + 1
    assert attention_backward.launches == k5 + 1

    def split(x):
        return layers.split_heads(x, h)

    want = attention_backward_plain(split(q), split(k), split(v), split(g), 0.125)
    for a, b in zip(got, want):
        b = layers.merge_heads(b)
        assert a.shape == b.shape and a.dtype == dtype
        assert (a.float() - b.float()).abs().max().item() < (
            tol * b.float().abs().max().item())


def test_merged_tokens_cuda_equal_cpu(dev):
    """f32 test-tiny with the fused switch on: the encoder runs K10 on CUDA
    (once a layer) and the greedy tokens equal the CPU's."""
    from dataclasses import replace

    from whisper_ipa_torch.decode import DecodingOptions, decode
    from whisper_ipa_torch.models import params_to
    from whisper_ipa_torch.tokenizer import get_tokenizer

    cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=150, n_text_ctx=48)
    cpu_params = init_params(cfg, seed=0)
    mel = torch.randn((2, 300, cfg.n_mels),
                      generator=torch.Generator().manual_seed(0))
    opts = DecodingOptions(language="en", without_timestamps=True,
                           sample_len=16, kv_int8=True)
    tok = get_tokenizer(multilingual=True, language="en")
    layers.use_fused_attention(True)
    layers.use_merged_attention(True)
    try:
        k10, k2 = fused_attention_merged.launches, fused_attention.launches
        gpu = decode(params_to(cpu_params, dev), cfg, mel, opts, tokenizer=tok)
        assert fused_attention_merged.launches - k10 == cfg.n_audio_layer
        assert fused_attention.launches == k2
        cpu = decode(cpu_params, cfg, mel, opts, tokenizer=tok)
    finally:
        layers.use_merged_attention(False)
        layers.use_fused_attention(None)
    assert [r.tokens for r in gpu] == [r.tokens for r in cpu]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_engine_tokens_equal_the_cpu(dev, kv_int8):
    """test-tiny in f32: the in-flight engine on the card (K1, and K4 with
    the int8 cross cache) answers six staggered requests, some of two
    windows, through two slots with the CPU engine's tokens."""
    import time
    from dataclasses import replace

    import numpy as np

    from whisper_ipa_torch.serve_continuous import ContinuousBatcher
    from whisper_ipa_torch.tokenizer import get_tokenizer

    cfg = replace(CONFIGS["test-tiny"], n_text_ctx=48)
    params = init_params(cfg, seed=0)
    tok = get_tokenizer(multilingual=True, language="en")
    rng = np.random.default_rng(0)
    audios = [(0.1 * rng.standard_normal(int(rng.integers(8000, 40 * 16000))))
              .astype(np.float32) for _ in range(6)]
    out = {}
    k1, k4 = log_mel_power.launches, decode_cross_attention_int8_tminor.launches
    for device in ("cpu", dev):
        eng = ContinuousBatcher(params, cfg, device=device, slots=2,
                                max_new_tokens=16, steps_per_sync=2,
                                tokenizer=tok, kv_int8=kv_int8)
        try:
            futs = []
            for a in audios:
                futs.append(eng.submit(a))
                time.sleep(0.01)
            out[str(device)] = [f.result(timeout=600)["tokens"] for f in futs]
        finally:
            eng.close()
    assert out["cpu"] == out[str(dev)]
    assert log_mel_power.launches > k1
    assert (decode_cross_attention_int8_tminor.launches > k4) == kv_int8


# -- the parallel slice: local-head shapes and a one-rank NCCL group ------


@pytest.mark.parametrize("tp", [2, 4])
def test_kernels_at_tensor_parallel_local_heads(dev, tp):
    """K2, K4 and K5 at whisper-small's local head count under tp 2 and 4
    (12 / tp heads of width 64, T 1500, the int8 cache's T_pad 1536), bf16,
    against their plain versions with the bounds above."""
    gen = torch.Generator(device=dev).manual_seed(tp)
    heads = 12 // tp
    q, k, v, g = (torch.randn((4, heads, 1500, 64), generator=gen,
                              device=dev).to(torch.bfloat16) for _ in range(4))
    got = fused_attention(q, k, v, 0.125)
    assert _bf16_close(got, attention_plain(q, k, v, 0.125), 5e-3)
    out, lse = _forward_kernel(q, k, v, 0.125, with_lse=True)
    grads = attention_backward(q, k, v, out, g, lse, 0.125)
    for a, b in zip(grads, attention_backward_plain(q, k, v, g, 0.125)):
        assert _grad_err_ok(a, b, 1e-2)
    codes = [torch.randint(-127, 128, (16, heads, 64, 1536), generator=gen,
                           device=dev).to(torch.int8) for _ in range(2)]
    scales = [0.01 + 0.02 * torch.rand((16, heads, 1536), generator=gen,
                                       device=dev) for _ in range(2)]
    for s in scales:
        s[..., 1500:] = 0.0
    qd = (torch.randn((16, heads, 1, 64), generator=gen, device=dev)
          * 0.125).to(torch.bfloat16)
    got = decode_cross_attention_int8_tminor(qd, codes[0], scales[0], codes[1],
                                             scales[1])
    want = decode_attention_plain(qd, codes[0], scales[0], codes[1], scales[1])
    assert (got.float() - want.float()).abs().max().item() <= (
        0.02 * want.float().abs().max().item())


def test_one_rank_nccl_collectives(dev):
    """parallel.initialize with NCCL named at world 1: the helpers are
    identities on CUDA tensors; the group is destroyed after."""
    import socket

    import torch.distributed as dist

    from whisper_ipa_torch.parallel import distributed as D
    from whisper_ipa_torch.parallel import initialize

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize(f"localhost:{port}", 1, 0, device=dev, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        x = torch.randn((4, 6), device=dev)
        assert torch.equal(D.all_reduce(x.clone()), x)
        assert torch.equal(D.all_gather(x, dim=1), x)
        assert torch.equal(D.reduce_scatter(x.clone(), dim=0), x)
        assert torch.equal(D.broadcast(x.clone(), src=0), x)
    finally:
        dist.destroy_process_group()
