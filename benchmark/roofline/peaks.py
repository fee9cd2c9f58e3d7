"""Published dense peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
without sparsity, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,
        "int8_ops": 1979e12,
        "bytes_per_s": 3.35e12,
    },
}


def peak(device_name: str, key: str) -> Optional[float]:
    """One peak of the named card, None for a card not in the table (a
    share of its peak is then not reported)."""
    return PEAKS.get(device_name, {}).get(key)


def bound_s(device_name: str, n_bytes: float, n_flops: float,
            flop_key: str = "bf16_flops") -> Optional[float]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for their type."""
    bw, fl = peak(device_name, "bytes_per_s"), peak(device_name, flop_key)
    if bw is None or fl is None:
        return None
    return max(n_bytes / bw, n_flops / fl)
