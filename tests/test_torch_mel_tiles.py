"""PyTorch port: K1's factorized design (the log-mel frontend as two stages
of 20-point DFTs and a sparse mel product) pinned against the plain
version and the JAX package.

The kernel runs only on the card. Its arithmetic is emulated here in torch,
in f32 and in the kernel's stage order, on inputs made from a seed with
numpy:

- stage 1: for each n2, the 20-point DFT over n1 of hann[n] * x[n] (n =
  20 n1 + n2), accumulated over n1 in order, outputs k1 = 0..10 only, then
  times the twiddle W400^(n2 k1);
- stage 2: bins k1 + 20 k2 for k1 = 0..10 from those outputs, and bins
  20 - p + 20 k2 from the conjugates times W20^n2, accumulated over n2 in
  order, bins 0..200 and no more;
- the mel product over each filter's nonzero bin range, in bin order, and
  the log10 clamp.

The 20th roots of unity are read as the kernel reads them (j <= 10 from the
table, the rest by symmetry). Held against ``log_mel_power_plain`` and
``log_mel_spectrogram_pallas(interpret=True)`` within 5e-4 after
``normalize`` (the bound of tests/test_pallas_mel.py and of the card).
"""

import numpy as np
import pytest
import torch

from whisper_ipa_tpu.ops import log_mel_spectrogram_pallas
from whisper_ipa_torch.audio.mel import (
    N_FFT,
    SAMPLE_RATE,
    _dft_mel_operators,
    _hann_periodic,
)
from whisper_ipa_torch.ops.mel_kernel import (
    FFT_HALF,
    FFT_RADIX,
    _operators,
    fft_operators,
    log_mel_power_plain,
    normalize,
    reflect_pad,
)

torch.set_num_threads(1)


def _roots(w20):
    """cos and sin of 2 pi j / 20 for j < 20, from j <= 10 by symmetry."""
    c = [w20[0][j] if j <= 10 else w20[0][20 - j] for j in range(20)]
    s = [w20[1][j] if j <= 10 else -w20[1][20 - j] for j in range(20)]
    return torch.tensor(np.array(c)), torch.tensor(np.array(s))


def emulate_k1_power(padded, n_mels):
    """|X|^2 of every frame, (B, n_frames, 201) f32, in K1's stage order."""
    window, w20, twiddle, _ = fft_operators(n_mels)
    c, s = _roots(w20)
    tc, ts = torch.from_numpy(twiddle[0]), torch.from_numpy(twiddle[1])
    B = padded.shape[0]
    nf = (padded.shape[-1] - N_FFT) // 160
    frames = padded.unfold(-1, N_FFT, 160)[:, :nf]
    y = (frames * torch.from_numpy(window)).reshape(B, nf, FFT_RADIX, FFT_RADIX)
    k1 = torch.arange(FFT_HALF)
    re = torch.zeros(B, nf, FFT_RADIX, FFT_HALF)
    im = torch.zeros(B, nf, FFT_RADIX, FFT_HALF)
    for n1 in range(FFT_RADIX):  # y[:, :, n1, n2] = hann * x at 20 n1 + n2
        j = (n1 * k1) % FFT_RADIX
        yn = y[:, :, n1, :, None]
        re = re + yn * c[j]
        im = im + (-yn) * s[j]
    zr = re * tc + im * ts  # (re + i im)(tc - i ts)
    zi = im * tc + (-re) * ts
    power = torch.zeros(B, nf, N_FFT // 2 + 1)
    for p in range(FFT_HALF):
        k2 = torch.arange(11 if p == 0 else 10)
        dr = di = torch.zeros(B, nf, len(k2))
        mr = mi = torch.zeros(B, nf, 10)
        for n2 in range(FFT_RADIX):
            a, b = zr[:, :, n2, p, None], zi[:, :, n2, p, None]
            j = (n2 * k2) % FFT_RADIX
            dr = dr + a * c[j] + b * s[j]
            di = di + b * c[j] + (-a) * s[j]
            if 1 <= p <= 9:  # bins 20 - p + 20 k2: conj(Z') W20^(n2 (k2 + 1))
                jm = (n2 * (torch.arange(10) + 1)) % FFT_RADIX
                mr = mr + a * c[jm] + (-b) * s[jm]
                mi = mi + (-b) * c[jm] + (-a) * s[jm]
        power[..., p + 20 * k2] = dr * dr + di * di
        if 1 <= p <= 9:
            power[..., 20 - p + 20 * torch.arange(10)] = mr * mr + mi * mi
    return power


def mel_in_bin_order(power, n_mels, sparse: bool):
    """The mel product as sums in bin order, over each filter's nonzero
    range (sparse) or over all 201 bins (dense)."""
    mel_t = torch.from_numpy(_dft_mel_operators(n_mels)[2])
    rng = torch.from_numpy(fft_operators(n_mels)[3])
    acc = torch.zeros(*power.shape[:-1], n_mels)
    for k in range(power.shape[-1]):
        term = acc + power[..., k:k + 1] * mel_t[k]
        if sparse:
            term = torch.where((rng[:, 0] <= k) & (k < rng[:, 1]), term, acc)
        acc = term
    return acc


def emulate_k1(padded, n_mels):
    """K1: (B, n + 400) padded f32 -> (B, n // 160, n_mels) log10 mel."""
    mel = mel_in_bin_order(emulate_k1_power(padded, n_mels), n_mels, sparse=True)
    return torch.log10(torch.clamp_min(mel, 1e-10))


def _audio(batch, n_samples, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / SAMPLE_RATE
    return (0.1 * rng.standard_normal((batch, n_samples))
            + 0.3 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_samples", [
    SAMPLE_RATE,       # 1 s: 100 frames, three tiles of 32 and a ragged one
    30 * SAMPLE_RATE,  # a 30 s window: 3000 frames, the main path's
    21_937,            # not a whole hop: 137 frames
])
def test_k1_design_matches_plain_and_pallas(n_mels, n_samples):
    audio = _audio(1, n_samples, seed=n_samples + n_mels)
    padded = reflect_pad(torch.from_numpy(audio)).contiguous()
    emu = normalize(emulate_k1(padded, n_mels))
    assert emu.shape == (1, n_samples // 160, n_mels)
    plain = normalize(log_mel_power_plain(padded, n_mels))
    assert (emu - plain).abs().max().item() < 5e-4
    pallas = np.asarray(log_mel_spectrogram_pallas(audio, n_mels=n_mels,
                                                   interpret=True))
    assert np.abs(emu.numpy() - pallas).max() < 5e-4


def test_k1_design_rows_are_independent():
    """Two batch rows through the emulation equal each row alone."""
    audio = _audio(2, 4_000, seed=1)
    padded = reflect_pad(torch.from_numpy(audio)).contiguous()
    both = emulate_k1(padded, 80)
    for r in range(2):
        torch.testing.assert_close(both[r], emulate_k1(padded[r:r + 1], 80)[0],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_sparse_mel_equals_dense_bit_for_bit(n_mels):
    """Skipping a filter's exact-zero weights leaves every sum, taken in
    bin order, equal to the dense one bit for bit; the ranges hold 391
    (80 mels) and 394 (128 mels) of the filterbank's weights, all of its
    nonzeros, and no zero inside a range."""
    rng = np.random.default_rng(n_mels)
    power = torch.from_numpy(
        (rng.random((3, 7, 201)) ** 4 * 10.0 ** rng.integers(-6, 3, (3, 7, 201)))
        .astype(np.float32))
    sparse = mel_in_bin_order(power, n_mels, sparse=True)
    dense = mel_in_bin_order(power, n_mels, sparse=False)
    assert torch.equal(sparse, dense)
    mel_t = _dft_mel_operators(n_mels)[2]
    ranges = fft_operators(n_mels)[3]
    inside = sum(int(hi - lo) for lo, hi in ranges)
    assert inside == int((mel_t != 0).sum()) == {80: 391, 128: 394}[n_mels]
    for m, (lo, hi) in enumerate(ranges):
        assert (mel_t[lo:hi, m] != 0).all()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_fft_operators_shapes_and_values(n_mels):
    """The kernel's constants: shapes, and float64 values rounded once to
    f32; ``_operators`` carries them next to the plain version's bases."""
    window, w20, twiddle, mel_range = fft_operators(n_mels)
    assert window.shape == (400,) and window.dtype == np.float32
    assert w20.shape == (2, 20) and w20.dtype == np.float32
    assert twiddle.shape == (2, 20, 11) and twiddle.dtype == np.float32
    assert mel_range.shape == (n_mels, 2) and mel_range.dtype == np.int32
    j = np.arange(20, dtype=np.float64)
    np.testing.assert_array_equal(w20[0], np.cos(2 * np.pi * j / 20).astype(np.float32))
    np.testing.assert_array_equal(w20[1], np.sin(2 * np.pi * j / 20).astype(np.float32))
    ang = 2 * np.pi * np.outer(j, np.arange(11)) / 400
    np.testing.assert_array_equal(twiddle[0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(twiddle[1], np.sin(ang).astype(np.float32))
    np.testing.assert_array_equal(window, _hann_periodic().astype(np.float32))
    ops = _operators(n_mels, torch.device("cpu"))
    assert ops.cos_b.shape == ops.sin_b.shape == (400, 201)
    assert ops.mel_t.shape == (201, n_mels)
    assert ops.mel_range.dtype == torch.int32
    assert torch.equal(ops.twiddle, torch.from_numpy(twiddle))
