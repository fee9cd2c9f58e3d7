"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device, and runs on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda

which builds the kernels with nvcc on first use. ``chip_smoke.py`` runs the
same comparisons at the main path's full shapes.
"""

import pytest
import torch

from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.models import init_params
from whisper_ipa_torch.models.convert import flatten_params
from whisper_ipa_torch.models import layers
from whisper_ipa_torch.models.whisper import _quantize_kv_heads4
from whisper_ipa_torch.ops import (
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
)
from whisper_ipa_torch.ops.quant import quantize_linear, quantize_linear_int4
from whisper_ipa_torch.ops.attention import (
    _forward_kernel,
    attention_merged_plain,
    fused_attention_merged,
)
from whisper_ipa_torch.ops.sr_quant import (
    stochastic_quantize_int8,
    stochastic_quantize_int8_plain,
)
from whisper_ipa_torch.ops.mel_kernel import normalize, reflect_pad
from whisper_ipa_torch.train import create_train_state, train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel(dev, n_mels):
    gen = torch.Generator(device=dev).manual_seed(0)
    audio = 0.1 * torch.randn((2, 48_000 + 37), generator=gen, device=dev)
    padded = reflect_pad(audio).contiguous()
    before = log_mel_power.launches
    got = normalize(log_mel_power(padded, n_mels))
    assert log_mel_power.launches == before + 1
    want = normalize(log_mel_power_plain(padded, n_mels))
    assert got.shape == (2, 300, n_mels)
    assert (got - want).abs().max().item() < 5e-4


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk", [(128, 128), (256, 300), (130, 257)])
def test_attention_kernel(dev, tq, tk, dh, dtype, atol):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (
        torch.randn((2, 3, t, dh), generator=gen, device=dev).to(dtype)
        for t in (tq, tk, tk)
    )
    before = fused_attention.launches
    got = fused_attention(q, k, v, dh ** -0.5)
    assert fused_attention.launches == before + 1
    want = attention_plain(q, k, v, dh ** -0.5)
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk", [(130, 257), (1100, 300)])
def test_attention_backward_kernel(dev, tq, tk, dh, dtype, tol):
    """K5 against its plain version, relative to max|grad|: f32 1e-4 (another
    summation order than cuBLAS), bf16 2% (the plain version rounds P and dS
    to bf16 before its products; the kernel keeps them in f32)."""
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
        err = (a.float() - b.float()).abs().max().item()
        assert err < tol * b.float().abs().max().item()


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


def _rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(16, 768, 768), (1000, 768, 768), (37, 3072, 768)])
def test_int8_matmul_kernel(dev, m, k, n, dtype):
    """K6 against its plain version: the same integer sums, rescaled in
    f32; rows not a multiple of the 64-row tile. Relative 1e-6 of max|y|."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = quantize_linear({"w": 0.05 * torch.randn((k, n), generator=gen, device=dev)})
    w_q, w_s = q["w_q"].to(dev), q["w_s"].to(dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    before = int8_matmul.launches
    got = int8_matmul(x, w_q, w_s)
    assert int8_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got, int8_matmul_plain(x, w_q, w_s)) <= 1e-6


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("B,T,d,H", [(2, 150, 64, 2), (2, 1500, 768, 12)])
def test_kv_init_kernel(dev, B, T, d, H, bias, dtype):
    """K3 against its plain version (cuBLAS sums in another order, so a
    bf16 rounding of the projection may fall the other way): scales within
    2^-7 relative in bf16 (one ulp of the head's maximum), 2^-6 in bf16
    with a bias (one ulp of the projection, then the bias add's own
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
    for i in (0, 2):
        diff = (got[i].int() - want[i].int()).abs()
        same_scale = (got[i + 1] == want[i + 1])[:, :, None, :]
        assert (diff <= torch.where(same_scale, 1, 2)).all()
        assert (diff == 0).float().mean().item() >= 0.999
        assert (got[i][..., T:] == 0).all()
    for i in (1, 3):
        assert ((got[i] - want[i]).abs() <= tol * want[i].abs()).all()
        assert (got[i][..., T:] == 0).all() and (got[i][..., :T] > 0).all()


@pytest.mark.parametrize("rows,cols", [(256, 64), (300, 70), (768, 3072), (3072, 768)])
def test_sr_quant_kernel(dev, rows, cols):
    """K9 equals its plain version bit for bit (the same Philox bits and
    IEEE divisions), its scales equal the host quantizer's, and the codes
    stay on the card."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = 0.05 * torch.randn((rows, cols), generator=gen, device=dev)
    w[:, 0] = 0.0  # an all-zero column: scale 1e-8 / 127, codes 0
    before = stochastic_quantize_int8.launches
    q, s = stochastic_quantize_int8(w, seed=17)
    assert stochastic_quantize_int8.launches == before + 1
    assert q.device == w.device and q.dtype == torch.int8 and s.shape == (cols,)
    pq, ps = stochastic_quantize_int8_plain(w, seed=17)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    host = quantize_linear({"w": w.cpu()})
    assert torch.equal(s[1:].cpu(), host["w_s"][1:])
    assert (q[:, 0] == 0).all()
    assert (q.int().cpu() - host["w_q"].int()).abs().max().item() <= 1


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
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
    assert (got.float() - want.float()).abs().max().item() < atol

    def split(x):
        return layers.split_heads(x, h).contiguous()

    k2 = layers.merge_heads(fused_attention(split(q), split(k), split(v), scale))
    assert torch.equal(got, k2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
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
