"""Scoped full-fp32 precision for float32 products on the card.

A float32 matrix product on CUDA runs in full fp32 by default
(``torch.backends.cuda.matmul.allow_tf32`` is False), but a float32
convolution goes through cuDNN in TF32 (``torch.backends.cudnn.allow_tf32``
is True), which keeps ~3 decimal digits. The JAX reference computes both at
full fp32: the conv stem (``models/layers.conv1d``) and the mel DFT, whose
power spectrum feeds a log10 over 8 decades. ``full_fp32()`` turns both
flags off for the duration of a call and restores them when the last
caller leaves, so importing this package changes no global setting.

The flags are process-wide, not per thread, so nested and concurrent
scopes (the service's scheduler thread beside a caller's thread) share one
depth count: the flags are saved on the first entry and restored on the
last exit.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch


class _Scope:
    lock = threading.Lock()
    depth = 0
    saved = (False, True)


@contextmanager
def full_fp32():
    with _Scope.lock:
        if _Scope.depth == 0:
            _Scope.saved = (
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
            )
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _Scope.depth += 1
    try:
        yield
    finally:
        with _Scope.lock:
            _Scope.depth -= 1
            if _Scope.depth == 0:
                (
                    torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                ) = _Scope.saved
