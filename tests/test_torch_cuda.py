"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where there is no CUDA
device, and runs on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda

which builds the kernels with nvcc on first use. ``chip_smoke.py`` runs the
same comparisons at the main path's full shapes.
"""

import pytest
import torch

from whisper_ipa_torch.ops import (
    attention_plain,
    decode_attention_plain,
    decode_cross_attention_int8_tminor,
    fused_attention,
    log_mel_power,
    log_mel_power_plain,
)
from whisper_ipa_torch.ops.mel_kernel import normalize, reflect_pad

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


def test_attention_kernel_refuses_grad(dev):
    """No backward kernel yet: inputs that need a gradient are refused."""
    q = torch.randn((1, 1, 128, 64), device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError):
        fused_attention(q, q.detach(), q.detach())
