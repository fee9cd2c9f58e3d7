"""Operations and bytes that one call of an operation needs at its shapes,
whatever kernel implements it (``chip_smoke.py``'s counts, copied).

Each input byte is counted read once and each output byte written once.
"""

from __future__ import annotations


def encoder_attention(bh: int, t: int, dh: int, elem_bytes: int = 2):
    """Unmasked self-attention over (B·H, T, Dh): q·k and p·v, 2 FLOPs a
    multiply-accumulate; q, k, v read and the output written once.
    Returns (bytes, flops)."""
    return 4 * bh * t * dh * elem_bytes, 4.0 * bh * t * t * dh


def int8_cross_attention(bh: int, t: int, dh: int, q_bytes: int = 2):
    """Single-query attention over an int8 T-minor cache of ``t`` positions:
    the K and V codes (1 byte) and their per-position f32 scales read once,
    q read and the output written once. Returns (bytes, flops)."""
    codes = 2 * bh * dh * t
    scales = 2 * bh * t * 4
    q_out = 2 * bh * dh * q_bytes
    return codes + scales + q_out, 4.0 * bh * t * dh
