"""ctypes bindings for the native C++ metric cores (native/editdistance.cpp).

The PyTorch package's copy of ``whisper_ipa_tpu/metrics/native.py``: the
same host library (``native/libwipa_native.so``; the card is not involved).
Importing this module raises if the shared library has not been built; the
callers in per.py/pfer.py catch that and take the NumPy/Python DPs, which
compute the same distances. Build with ``make -C native``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

_LIB_NAME = "libwipa_native.so"


def _find_library() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.abspath(os.path.join(here, "..", ".."))
    candidates = [
        os.environ.get("WHISPER_IPA_TPU_NATIVE_LIB"),
        os.path.join(repo_root, "native", _LIB_NAME),
        os.path.join(here, _LIB_NAME),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise OSError(f"{_LIB_NAME} not found; run `make -C native`")


_lib = ctypes.CDLL(_find_library())

_lib.wipa_levenshtein.restype = ctypes.c_int64
_lib.wipa_levenshtein.argtypes = [
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64,
]
_lib.wipa_weighted_edit_distance.restype = ctypes.c_double
_lib.wipa_weighted_edit_distance.argtypes = [
    ctypes.POINTER(ctypes.c_double),
    ctypes.c_int64,
    ctypes.c_int64,
]
_lib.wipa_cosine_edit_distance.restype = ctypes.c_double
_lib.wipa_cosine_edit_distance.argtypes = [
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_int64,
    ctypes.c_int64,
]


def levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    a_arr = np.ascontiguousarray(a, dtype=np.int64)
    b_arr = np.ascontiguousarray(b, dtype=np.int64)
    return int(
        _lib.wipa_levenshtein(
            a_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(a_arr),
            b_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(b_arr),
        )
    )


def weighted_edit_distance(sub_cost: np.ndarray) -> float:
    sc = np.ascontiguousarray(sub_cost, dtype=np.float64)
    m, n = sc.shape
    return float(
        _lib.wipa_weighted_edit_distance(
            sc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m, n
        )
    )


def cosine_edit_distance(penalty: np.ndarray, equal: np.ndarray) -> float:
    p = np.ascontiguousarray(penalty, dtype=np.float64)
    e = np.ascontiguousarray(equal, dtype=np.uint8)
    m, n = p.shape
    return float(
        _lib.wipa_cosine_edit_distance(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            e.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            m,
            n,
        )
    )
