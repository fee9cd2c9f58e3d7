"""The precision the reference computes its products in.

``FP32`` is the reference. ``FP8`` is its control: both operands of every
product rounded to float8 e4m3 with one scale a tensor (amax / 448), then
multiplied in float32, the step below the bfloat16 that the benchmark's
configurations state. Autograd sees the rounded operands, so a backward
through the control multiplies them too.
"""

from __future__ import annotations

import torch


class Precision:
    name = "fp32"

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a.float()), self.round(b.float()))


class Float8(Precision):
    name = "fp8_e4m3"
    MAX = 448.0

    def round(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp_min(1e-30) / self.MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach() if x.requires_grad else q


FP32 = Precision()
FP8 = Float8()
