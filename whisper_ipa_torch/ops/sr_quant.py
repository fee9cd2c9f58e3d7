"""Stochastic-rounding int8 weight quantization on the device: the K9
kernel (``csrc/sr_quant.cu``) and its plain version.

Counterpart of ``whisper_ipa_tpu/ops/sr_quant.py``. The host quantizer
(``ops/quant.quantize_params``) copies every weight to the host and back;
``quantize_params_device`` quantizes the weights where they lie, in one
pass over device memory, with the same output layout: {"w_q": int8 (in,
out), "w_s": f32 (out,)}, "w" dropped.

Per output channel, s = max(max|w[:, o]|, 1e-8) / 127 and q = clip(floor(w
/ s + u), -127, 127) with u uniform in [0, 1): rounding is stochastic, so
E[q s] = w. u comes from a counter-based Philox4x32-10 keyed by the seed
and indexed by (row, col), in the kernel and in the plain version alike, so
the two agree bit for bit; four neighbouring columns share one Philox
block. The JAX package draws u from the TPU's own bits or ``jax.random``;
those bits are not reproduced, only the contract: codes are the floor or
the ceiling of the IEEE quotient, the error is below one step, the mean is
unbiased, and the scales equal the host quantizer's.

``stochastic_quantize_int8_many`` quantizes a list of weights in one
launch (``sr_quant_plan`` lays out its tiles), and ``quantize_params_device``
calls it once for the tree. CPU tensors run the plain version; CUDA
tensors run the kernel or raise.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from . import _build
from .precision import div_ieee

_MASK32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (the Random123 constants)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for uint32 values held in int64: the
    64-bit product does not fit in int64, so c is split into 16-bit limbs
    (each partial product is below 2^48)."""
    t = m * (c & 0xFFFF)
    u = m * (c >> 16)
    hi = (u + (t >> 16)) >> 16
    lo = (t + ((u & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counters (c0..c3), int64 tensors of uint32 values,
    under key (k0, k1); returns the four output words the same way."""
    k0 &= _MASK32
    k1 &= _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_bits(rows: int, cols: int, seed: int, device=None) -> torch.Tensor:
    """(rows, cols) f32 u in [0, 1): for column c of row r, word c % 4 of
    Philox4x32-10 at counter (c // 4, r, 0, 0) and key (seed, 0), its top
    23 bits as a mantissa. One Philox block gives four neighbouring
    columns their uniforms."""
    groups = (cols + 3) // 4
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    c0, c1 = j.expand(rows, groups), r.expand(rows, groups)
    zero = torch.zeros_like(c0)
    words = torch.stack(philox4x32_10(c0, c1, zero, zero, seed, 0), dim=-1)
    bits = words.reshape(rows, 4 * groups)[:, :cols]
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def stochastic_quantize_int8_plain(w: torch.Tensor, seed: int = 0):
    """Plain PyTorch K9: (in, out) -> (int8 codes (in, out), f32 scales
    (out,)), with the kernel's arithmetic (IEEE divisions, Philox bits)."""
    w = w.to(torch.float32)
    s = div_ieee(torch.clamp_min(w.abs().amax(dim=0), 1e-8), 127.0)
    u = uniform_bits(w.shape[0], w.shape[1], seed, w.device)
    q = torch.clamp(torch.floor(w / s + u), -127, 127).to(torch.int8)
    return q, s


# The launch geometry of csrc/sr_quant.cu (kCluster, kMaxStrip, kMaxStage,
# kMaxEntries there; the first launch holds these against the library's
# wipa_sr_quant_geometry)
CLUSTER = 8            # blocks a cluster, along a strip's rows
STRIPS = (128, 64, 32)  # the columns a tile may have, widest first
MAX_STAGE = 24576      # floats of a block's slice in shared memory (96 KB)
MAX_ENTRIES = 640      # weights a launch (the kernel's parameter table)


@dataclass(frozen=True)
class SrQuantPlan:
    """One launch of K9 over a list of weight shapes.

    A tile is a strip of ``strips[i]`` columns of weight i over all its
    rows; weight i has ceil(cols / strips[i]) tiles. ``order`` lists the
    weights in tile order, ``tile0[k]`` the first tile of ``order[k]``.
    Tile t is the cluster of blocks t * CLUSTER .. t * CLUSTER + CLUSTER -
    1; block ``rank`` of it owns rows [rank * slice, (rank + 1) * slice) of
    its strip, slice = ceil(rows / CLUSTER). A block holds its slice (slice
    * strip floats) in shared memory if that is at most ``stage`` floats,
    the launch's shared memory a block; else it reads its slice twice."""

    shapes: Tuple[Tuple[int, int], ...]
    strips: Tuple[int, ...]
    order: Tuple[int, ...]
    tile0: Tuple[int, ...]
    tiles: int
    stage: int


def sr_quant_plan(shapes: Sequence[Tuple[int, int]]) -> SrQuantPlan:
    """The launch plan of K9 over weights of these (rows, cols) shapes.

    The tallest slice that fits (at 32 columns) sets the floats a block
    holds; every weight then takes the widest strip whose slice fits in
    as many (and that its columns fill past 32), so a block of a short
    weight does as much work as one of a tall weight: a block's time is
    mostly latency, and the card wants many bytes in flight a block.
    Tiles go out in order of their floats, most first (then tallest).
    """
    shapes = tuple((int(r), int(c)) for r, c in shapes)
    if not shapes or any(r < 1 or c < 1 for r, c in shapes):
        raise ValueError(f"want non-empty (in, out) shapes, got {shapes}")
    if len(shapes) > MAX_ENTRIES:
        raise ValueError(f"{len(shapes)} weights: a launch takes at most "
                         f"{MAX_ENTRIES}")
    slices = [-(-r // CLUSTER) for r, _ in shapes]
    target = max((32 * x for x in slices if 32 * x <= MAX_STAGE), default=0)
    strips = tuple(
        next((w for w in STRIPS if x * w <= target and w < c + 32), STRIPS[-1])
        for x, (_, c) in zip(slices, shapes))
    stage = max([x * w for x, w in zip(slices, strips) if x * w <= target],
                default=0)
    order = tuple(sorted(range(len(shapes)),
                         key=lambda i: (-slices[i] * strips[i], -shapes[i][0])))
    tile0, t = [], 0
    for i in order:
        tile0.append(t)
        t += -(-shapes[i][1] // strips[i])
    return SrQuantPlan(shapes, strips, order, tuple(tile0), t, stage)


class _Entry(ctypes.Structure):
    """One weight of the kernel's table (csrc/sr_quant.cu, Entry)."""

    _fields_ = [("w", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("s", ctypes.c_void_p), ("rows", ctypes.c_int),
                ("cols", ctypes.c_int), ("seed", ctypes.c_uint32),
                ("tile0", ctypes.c_int), ("strip", ctypes.c_int)]


_geometry_checked = False


def _check_geometry() -> None:
    """Raise unless the library's launch geometry is this module's."""
    global _geometry_checked
    if _geometry_checked:
        return
    out = (ctypes.c_int * 4)()
    _build.entry("sr_quant", "wipa_sr_quant_geometry", [_build.P])(out)
    want = (CLUSTER, STRIPS[0], MAX_STAGE, MAX_ENTRIES)
    if tuple(out) != want:
        raise RuntimeError(f"csrc/sr_quant.cu's geometry {tuple(out)} is not "
                           f"ops/sr_quant's {want}")
    _geometry_checked = True


def _launch(ws, qs, ss, seeds, device) -> None:
    _check_geometry()
    plan = sr_quant_plan([tuple(w.shape) for w in ws])
    table = (_Entry * len(ws))()
    for k, i in enumerate(plan.order):
        r, c = ws[i].shape
        table[k] = _Entry(ws[i].data_ptr(), qs[i].data_ptr(), ss[i].data_ptr(),
                          r, c, seeds[i] & _MASK32, plan.tile0[k],
                          plan.strips[i])
    fn = _build.entry(
        "sr_quant", "wipa_sr_quant_int8_many",
        [_build.P, _build.I, _build.I, _build.I, _build.I, _build.P],
    )
    rc = fn(ctypes.addressof(table), len(ws), plan.tiles, plan.stage,
            device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "wipa_sr_quant_int8_many")
    stochastic_quantize_int8_many.launches += 1


def _outputs(shapes, device):
    """Codes (r, c) int8 and scales (c,) f32 for each shape: views of one
    int8 and one f32 buffer. The weights of one shape share a region of
    each buffer, cut into views by one unbind (a view a weight would cost
    the host microseconds a weight); a region starts 16-byte aligned."""
    groups = {}
    for i, shape in enumerate(shapes):
        groups.setdefault(shape, []).append(i)
    q_buf = torch.empty((sum(-(-len(ix) * r * c // 16) * 16
                             for (r, c), ix in groups.items()),),
                        dtype=torch.int8, device=device)
    s_buf = torch.empty((sum(len(ix) * c for (_, c), ix in groups.items()),),
                        dtype=torch.float32, device=device)
    qs, ss = [None] * len(shapes), [None] * len(shapes)
    qo = so = 0
    for (r, c), ix in groups.items():
        k = len(ix)
        for i, q, s in zip(ix, q_buf[qo:qo + k * r * c].view(k, r, c).unbind(0),
                           s_buf[so:so + k * c].view(k, c).unbind(0)):
            qs[i], ss[i] = q, s
        qo += -(-k * r * c // 16) * 16
        so += k * c
    return qs, ss


def stochastic_quantize_int8_many(weights: Sequence[torch.Tensor],
                                  seeds: Sequence[int]):
    """K9 over a list of (in, out) weights, each with its seed: [(int8
    codes (in, out), f32 scales (out,))], as ``stochastic_quantize_int8``
    of each.

    CUDA tensors run the kernel, one launch for up to MAX_ENTRIES weights
    (more raise); the codes and scales are views of one int8 and one f32
    buffer (two allocations, not two a weight). CPU tensors run the plain
    version.
    """
    weights, seeds = list(weights), [int(s) for s in seeds]
    if len(weights) != len(seeds):
        raise ValueError(f"{len(weights)} weights, {len(seeds)} seeds")
    for w in weights:
        if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
            raise ValueError(
                f"want a non-empty (in, out) weight, got {tuple(w.shape)}")
    if not weights:
        return []
    devices = {w.device for w in weights}
    if len(devices) != 1:
        raise ValueError(f"weights on several devices: {devices}")
    (device,) = devices
    if device.type == "cpu":
        return [stochastic_quantize_int8_plain(w, s)
                for w, s in zip(weights, seeds)]
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    ws = [w.to(torch.float32).contiguous() for w in weights]
    qs, ss = _outputs([tuple(w.shape) for w in ws], device)
    _launch(ws, qs, ss, seeds, device)
    return list(zip(qs, ss))


stochastic_quantize_int8_many.launches = 0


def stochastic_quantize_int8(w: torch.Tensor, seed: int = 0):
    """K9 wrapper: (in, out) float -> (int8 codes (in, out), f32 scales
    (out,)), per-output-channel symmetric, stochastically rounded.

    CUDA tensors run the grouped kernel with a table of one, built by the
    library (the launch ``sr_quant_plan`` gives a list of one: no sort, no
    shared buffers, no table on the host); the outputs stay on the card.
    CPU tensors run the plain version.
    """
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(
            f"want a non-empty (in, out) weight, got {tuple(w.shape)}")
    if w.device.type == "cpu":
        return stochastic_quantize_int8_plain(w, seed)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    _check_geometry()
    w = w.to(torch.float32).contiguous()
    rows, cols = w.shape
    q = torch.empty((rows, cols), dtype=torch.int8, device=w.device)
    s = torch.empty((cols,), dtype=torch.float32, device=w.device)
    fn = _build.entry(
        "sr_quant", "wipa_sr_quant_int8",
        [_build.P, _build.P, _build.P, _build.I, _build.I, _build.U32,
         _build.I, _build.P],
    )
    rc = fn(w.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols,
            int(seed) & _MASK32, w.device.index,
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(rc, "wipa_sr_quant_int8")
    stochastic_quantize_int8_many.launches += 1
    return q, s


def _take_linears(tree, found):
    """``tree`` with "w" dropped from each linear's dict; (the new dict,
    its "w") appended to ``found`` in the reference's visit order. (A
    module-level function: a nested one that calls itself is a reference
    cycle, which would keep ``found`` and the codes alive until the
    cyclic collector runs.)"""
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            out = {k: v for k, v in tree.items() if k != "w"}
            found.append((out, w))
            return out
        return {k: _take_linears(v, found) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_take_linears(v, found) for v in tree]
    return tree


def quantize_params_device(params, quantize_encoder: bool = True,
                           seed: int = 0):
    """int8 weight quantization of a whole tree where it lies, one K9
    launch for all its block weights.

    The layout of ``ops/quant.quantize_params(bits=8)``; the block weights
    of the decoder, then of the encoder, each get seed + a running count in
    the reference's visit order, so a weight gets the same seed integer in
    both packages.
    """
    found = []  # (output dict, weight), in the reference's visit order
    out = dict(params)
    for side in ("decoder", "encoder") if quantize_encoder else ("decoder",):
        out[side] = {
            k: (_take_linears(v, found) if k == "blocks" else v)
            for k, v in params[side].items()
        }
    codes = stochastic_quantize_int8_many(
        [w for _, w in found], [seed + 1 + i for i in range(len(found))])
    for (p, _), (q, s) in zip(found, codes):
        p["w_q"] = q
        p["w_s"] = s
    return out
