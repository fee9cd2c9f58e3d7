"""Seeded synthetic speech-like audio, made on the device.

Each utterance is a voiced harmonic series (a fundamental of 90-250 Hz
with 3% vibrato, eight harmonics of random weight) under a syllable-rate
envelope (3-6 Hz), with a little noise, at the start of a 30 s window and
zero-padded after it, as Whisper pads. Lengths are stratified: a batch of
B utterances between ``lo`` and ``hi`` seconds always holds the same B
lengths, (lo + (hi - lo) (i + 1/2) / B), in an order drawn from the seed,
so every seed gives the same seconds of audio and the same work.
"""

from __future__ import annotations

import math

import torch

SAMPLE_RATE = 16000
WINDOW_SAMPLES = 30 * SAMPLE_RATE


def stratified_lengths(batch: int, lo: float, hi: float,
                       gen: torch.Generator) -> torch.Tensor:
    """(batch,) float64 seconds: the stratified set in a seeded order."""
    base = lo + (hi - lo) * (torch.arange(batch, dtype=torch.float64) + 0.5) / batch
    order = torch.randperm(batch, generator=gen, device=gen.device).cpu()
    return base[order]


def speech_batch(lengths_s: torch.Tensor, gen: torch.Generator,
                 device) -> torch.Tensor:
    """(B, 480000) float32 waveforms, each utterance zero-padded to 30 s."""
    B = lengths_s.shape[0]
    t = torch.arange(WINDOW_SAMPLES, device=device, dtype=torch.float32) / SAMPLE_RATE

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B, 1), generator=gen, device=device)

    f0 = uniform(90.0, 250.0)
    vib_rate, vib_phase = uniform(4.0, 7.0), uniform(0.0, 2 * math.pi)
    # the integral of f0 (1 + 0.03 sin(2 pi r t + p)) over t, times 2 pi
    phase = 2 * math.pi * f0 * t - (0.03 * f0 / vib_rate) * torch.cos(
        2 * math.pi * vib_rate * t + vib_phase)
    voiced = torch.zeros((B, WINDOW_SAMPLES), device=device)
    for h in range(1, 9):
        amp = uniform(0.2, 1.0) / h
        voiced += amp * torch.sin(h * phase)
    del phase
    syl_rate, syl_phase = uniform(3.0, 6.0), uniform(0.0, 2 * math.pi)
    env = 0.5 * (1.0 - torch.cos(2 * math.pi * syl_rate * t + syl_phase))
    voiced *= env
    del env
    voiced *= 0.1 / voiced.std(dim=1, keepdim=True).clamp_min(1e-6)
    voiced += 0.005 * torch.randn((B, WINDOW_SAMPLES), generator=gen, device=device)
    n = torch.round(lengths_s.to(device) * SAMPLE_RATE)
    voiced *= (torch.arange(WINDOW_SAMPLES, device=device)[None, :] < n[:, None])
    return voiced.contiguous()
