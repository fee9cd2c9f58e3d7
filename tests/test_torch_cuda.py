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
from whisper_ipa_torch.ops import (
    attention_backward,
    attention_backward_plain,
    attention_plain,
    decode_attention_plain,
    decode_cross_attention_int8_tminor,
    fused_attention,
    log_mel_power,
    log_mel_power_plain,
)
from whisper_ipa_torch.ops.attention import _forward_kernel
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
