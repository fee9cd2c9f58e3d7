"""PyTorch port: the plain versions of the K1, K2 and K4 kernels against the
JAX package (its Pallas kernels in interpret mode, and NumPy), the int8
cross-KV quantizer, and the wrappers' CPU behaviour.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.audio import SAMPLE_RATE, log_mel_spectrogram
from whisper_ipa_tpu.models.whisper import _quantize_kv_heads as jax_quantize
from whisper_ipa_tpu.ops import log_mel_spectrogram_pallas
from whisper_ipa_tpu.ops.attention import fused_attention as jax_fused_attention
from whisper_ipa_tpu.ops.decode_attention import (
    decode_cross_attention_int8_tminor as jax_decode_attention,
)
from whisper_ipa_torch.models.whisper import _quantize_kv_heads
from whisper_ipa_torch.ops import (
    attention_plain,
    decode_attention_plain,
    decode_cross_attention_int8_tminor,
    fused_attention,
    log_mel_power,
    log_mel_power_plain,
    log_mel_spectrogram as torch_log_mel,
)

torch.set_num_threads(1)


# -- K1: log-mel ------------------------------------------------------------

def _audio(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    return (
        0.4 * np.sin(2 * np.pi * 330.0 * t)
        + 0.05 * rng.standard_normal(t.shape)
    ).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_plain_matches_numpy_and_pallas(n_mels):
    """< 5e-4 in log-mel units, the bound of tests/test_pallas_mel.py."""
    audio = _audio(2.0)
    ref = log_mel_spectrogram(audio, n_mels=n_mels)
    pallas = np.asarray(
        log_mel_spectrogram_pallas(audio, n_mels=n_mels, interpret=True)
    )
    ours = torch_log_mel(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert ours.shape == ref.shape == pallas.shape == (200, n_mels)
    assert np.max(np.abs(ours - ref)) < 5e-4
    assert np.max(np.abs(ours - pallas)) < 5e-4


def test_mel_batched_rows_are_independent():
    batch = np.stack([_audio(1.0, seed=1), 0.1 * _audio(1.0, seed=2)])
    ours = torch_log_mel(torch.from_numpy(batch)).numpy()
    assert ours.shape == (2, 100, 80)
    for row in range(2):
        ref = log_mel_spectrogram(batch[row])
        assert np.max(np.abs(ours[row] - ref)) < 5e-4


# -- K2: encoder attention ------------------------------------------------

def _qkv(tq, tk, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 3, tq, dh)).astype(np.float32) * 0.3
    k = rng.standard_normal((2, 3, tk, dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((2, 3, tk, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk", [(128, 128), (256, 300), (130, 257)])
def test_attention_plain_matches_pallas(tq, tk, dh):
    """f32, scale folded into q: < 2e-5 (test_pallas_attention.py's bound)."""
    q, k, v = _qkv(tq, tk, dh)
    scale = dh ** -0.5
    ref = np.asarray(
        jax_fused_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True
        )
    )
    ours = attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale
    ).numpy()
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) < 2e-5


# -- K4: int8 single-query decode attention --------------------------------

def _int8_cache(B=2, H=3, dh=64, T=300, seed=0):
    """Quantized K/V of random features, T padded to 128 (scale 0 past T)."""
    rng = np.random.default_rng(seed)
    kf = rng.standard_normal((B, T, H * dh)).astype(np.float32)
    vf = rng.standard_normal((B, T, H * dh)).astype(np.float32)
    kq, ks = jax_quantize(jnp.asarray(kf), H)
    vq, vs = jax_quantize(jnp.asarray(vf), H)
    q = (rng.standard_normal((B, H, 1, dh)) * dh ** -0.5).astype(np.float32)
    return [np.array(a) for a in (q, kq, ks, vq, vs)]


@pytest.mark.parametrize("dh", [32, 64])
def test_decode_attention_plain_matches_pallas(dh):
    arrays = _int8_cache(dh=dh)
    assert arrays[2].shape[-1] == 384 and np.all(arrays[2][..., 300:] == 0)
    ref = np.asarray(
        jax_decode_attention(*[jnp.asarray(a) for a in arrays], interpret=True)
    )
    ours = decode_attention_plain(*[torch.from_numpy(a) for a in arrays]).numpy()
    assert ours.shape == ref.shape == (2, 3, 1, dh)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_decode_attention_ignores_padded_positions():
    """Scale-0 positions are masked: their codes do not change the output."""
    q, kq, ks, vq, vs = _int8_cache()
    kq2, vq2 = kq.copy(), vq.copy()
    kq2[..., 300:] = 127
    vq2[..., 300:] = -127
    a = decode_attention_plain(*[torch.from_numpy(x) for x in (q, kq, ks, vq, vs)])
    b = decode_attention_plain(
        *[torch.from_numpy(x) for x in (q, kq2, ks, vq2, vs)]
    )
    assert torch.equal(a, b)


# -- int8 cross-KV quantizer -------------------------------------------------

@pytest.mark.parametrize("T", [150, 256])
def test_quantize_kv_heads_matches_reference(T):
    rng = np.random.default_rng(T)
    x = (rng.standard_normal((2, T, 64)) * 0.5).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero position: scale floor 1e-8 / 127
    ref_q, ref_s = (np.asarray(a) for a in jax_quantize(jnp.asarray(x), 2))
    q, s = _quantize_kv_heads(torch.from_numpy(x), 2)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == ref_q.shape == (2, 2, 32, 256)
    assert s.shape == ref_s.shape == (2, 2, 256)
    np.testing.assert_allclose(s.numpy(), ref_s, rtol=1e-6, atol=0)
    diff = np.abs(q.numpy().astype(np.int32) - ref_q.astype(np.int32))
    assert diff.max() <= 1


# -- wrappers on CPU tensors --------------------------------------------------

def test_wrappers_use_plain_versions_on_cpu():
    """A CPU tensor takes the plain version and never counts a launch."""
    counters = (log_mel_power, fused_attention, decode_cross_attention_int8_tminor)
    before = [fn.launches for fn in counters]

    padded = torch.from_numpy(_audio(0.5)[None]).contiguous()
    padded = torch.nn.functional.pad(padded[:, None], (200, 200), mode="reflect")[:, 0]
    assert torch.equal(log_mel_power(padded, 80), log_mel_power_plain(padded, 80))

    q, k, v = (torch.from_numpy(a) for a in _qkv(130, 257, 32))
    assert torch.equal(fused_attention(q, k, v, 0.5), attention_plain(q, k, v, 0.5))

    arrays = [torch.from_numpy(a) for a in _int8_cache(dh=32)]
    assert torch.equal(
        decode_cross_attention_int8_tminor(*arrays), decode_attention_plain(*arrays)
    )
    assert [fn.launches for fn in counters] == before == [0, 0, 0]


def test_wrappers_check_their_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(128, 128, 32))
    with pytest.raises(ValueError):
        fused_attention(q, k[..., :16], v)
    with pytest.raises(ValueError):
        fused_attention(q.half(), k.half(), v.half())
    arrays = [torch.from_numpy(a) for a in _int8_cache(dh=32)]
    with pytest.raises(ValueError):  # T not padded to 128
        decode_cross_attention_int8_tminor(
            arrays[0], arrays[1][..., :300], arrays[2][..., :300],
            arrays[3][..., :300], arrays[4][..., :300],
        )
    with pytest.raises(ValueError):  # two queries
        decode_cross_attention_int8_tminor(
            torch.cat([arrays[0]] * 2, dim=2), *arrays[1:]
        )
    with pytest.raises(ValueError):
        log_mel_power(torch.zeros(1, 4000, dtype=torch.float64), 80)
