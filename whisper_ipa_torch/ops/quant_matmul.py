"""Quantized-weight matrix products: K6, int8 x int8 with per-row activation
quantization, and K7, int4 weights with group scales (both in
``csrc/quant_matmul.cu``), each beside its plain version.

Counterparts of ``whisper_ipa_tpu/ops/quant_matmul.int8_matmul`` and
``int4_matmul``. Both return f32; ``models/layers.linear`` casts to the
activation dtype and adds the bias, as the reference does.

K6 changes the numbers (the activations are quantized too), so it runs only
under ``layers.use_int8_activations(True)`` on CUDA. K7 computes what the
half-weight path computes; the port routes every decode-shaped ``w_q4``
call on CUDA to it, because eager PyTorch would otherwise write two
dequantized (K/2, N) half-weights per call.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .precision import div_ieee
from .quant import unpack_nibbles


def _rows(x):
    return x.reshape(-1, x.shape[-1])


def int8_matmul_plain(x, w_q, w_scale):
    """Plain PyTorch K6: (..., K) float x int8 (K, N) + f32 scales (N,) ->
    (..., N) f32.

    s = max(absmax over the row, 1e-6) / 127, codes = clip(round(x / s),
    -127, 127); the code products are summed in float64, which is exact
    here (|sum| <= K * 127^2 < 2^53), then rescaled in f32 as
    ``acc * s * w_scale``.
    """
    xf = _rows(x).float()
    x_scale = div_ieee(torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-6),
                       127.0)
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127)
    acc = torch.matmul(x_q.double(), w_q.double()).float()
    out = acc * x_scale * w_scale.float()
    return out.reshape(*x.shape[:-1], w_q.shape[1])


def int4_halves(w_q4, w_s4, dtype):
    """Packed (K/2, N) codes + group scales (K/G, N) -> the dequantized
    even-row and odd-row halves, each (K/2, N), in ``dtype`` (codes and
    scales cast first, then multiplied, as the reference does)."""
    n_half, n_out = w_q4.shape
    groups = w_s4.shape[0]
    s = w_s4[:, None, :].to(dtype)
    lo, hi = unpack_nibbles(w_q4, dtype)
    return ((lo.reshape(groups, -1, n_out) * s).reshape(n_half, n_out),
            (hi.reshape(groups, -1, n_out) * s).reshape(n_half, n_out))


def int4_matmul_plain(x, w_q4, w_s4):
    """Plain PyTorch K7: (..., K) float x packed int4 (K/2, N) + group
    scales (K/G, N) -> (..., N) f32: x in f32, codes dequantized in f32,
    ``x_even @ lo + x_odd @ hi``."""
    xf = _rows(x).float()
    lo, hi = int4_halves(w_q4, w_s4, torch.float32)
    out = xf[:, 0::2] @ lo + xf[:, 1::2] @ hi
    return out.reshape(*x.shape[:-1], w_q4.shape[1])


def _check_cuda(what: str, x, *tensors):
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: all operands must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: x must be f32 or bf16, got {x.dtype}")


# Rows up to which K6 runs its one-launch split-K body (decode shapes);
# above it the row pass and the 128 x 128 tensor-core tiles. On the H100
# (PERF.md section 6) the bodies cross between 48 and 64 rows at (768, 768)
# and split-K stays ahead through 64 at (3072, 768); the decode path's
# rows are 16 a step and 48 for the prefix, both on the split-K side.
SMALL_M_MAX = 64


def split_k_plan(K: int):
    """K6's small-M split of the K codes: (splits, slice), ``splits``
    blocks of one thread-block cluster (at most 8), each over ``slice``
    codes, a multiple of 32 and at least 128 where K allows, the last
    slice ragged."""
    splits = min(8, -(-K // 128))
    per_block = -(-K // splits)
    return splits, (per_block + 31) // 32 * 32


def _int8_kernel(xr, wq, ws, small: bool):
    """Launch K6 on contiguous CUDA (M, K) x and (K, N) codes: the
    split-K body when ``small`` (M <= 64), else the row pass and the
    tiles. Returns the (M, N) f32 product."""
    M, K = xr.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=xr.device)
    is_bf16 = int(xr.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(xr.device).cuda_stream
    if small:
        splits, slice_k = split_k_plan(K)
        fn = _build.entry("quant_matmul", "wipa_int8_matmul_small",
                          [_build.P] * 4 + [_build.I] * 7 + [_build.P])
        rc = fn(xr.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
                M, K, N, splits, slice_k, is_bf16, xr.device.index, stream)
    else:
        ldq = -(-K // 16) * 16  # scratch rows padded to whole 16-byte chunks
        x_codes = torch.empty((M, ldq), dtype=torch.int8, device=xr.device)
        x_scale = torch.empty((M,), dtype=torch.float32, device=xr.device)
        fn = _build.entry("quant_matmul", "wipa_int8_matmul",
                          [_build.P] * 6 + [_build.I] * 6 + [_build.P])
        rc = fn(xr.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(),
                x_codes.data_ptr(), x_scale.data_ptr(), M, K, N, ldq, is_bf16,
                xr.device.index, stream)
    _build.check(rc, "wipa_int8_matmul")
    return out


def int8_matmul(x, w_q, w_scale):
    """K6 wrapper: (..., K) f32/bf16 x int8 (K, N) + f32 (N,) -> (..., N) f32.

    CUDA tensors run the kernel, CPU tensors the plain version, whose
    output it equals bit for bit. K % 4 == 0; x 16-byte aligned.
    """
    K = x.shape[-1]
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[0] != K:
        raise ValueError(f"w_q must be int8 ({K}, N), got {w_q.dtype} "
                         f"{tuple(w_q.shape)}")
    N = w_q.shape[1]
    if w_scale.shape != (N,) or w_scale.dtype != torch.float32:
        raise ValueError("w_scale must be f32 (N,)")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, w_scale)
    _check_cuda("int8_matmul", x, w_q, w_scale)
    if K % 4:
        raise ValueError(f"int8_matmul needs K % 4 == 0, got {K}")
    xr, wq, ws = _rows(x).contiguous(), w_q.contiguous(), w_scale.contiguous()
    if xr.data_ptr() % 16:
        raise ValueError("int8_matmul reads x in 8- or 16-byte vectors: x must "
                         "be 16-byte aligned")
    out = _int8_kernel(xr, wq, ws, small=xr.shape[0] <= SMALL_M_MAX)
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


int8_matmul.launches = 0


# Rows up to which K7 runs its one-launch split-K body (decode and the
# prefix step: 16 and 48 rows); above it the warps-split body, which
# ``layers._int4_matmul_eligible`` still routes up to 2M elements of x.
INT4_SMALL_M_MAX = 64
INT4_TILE_N = 32      # output columns a block of the split-K body
INT4_TILE_M = 16      # output rows a block
INT4_MAX_SPLIT = 8    # K slices: blocks of one thread-block cluster
INT4_MAX_SLICE = 512  # packed rows a block: 64 KB of f32 x at most
INT4_SMEM_MAX = 200 * 1024  # a block's staged slice, in bytes
INT4_THREADS = 128    # threads a block


def int4_split_plan(M: int, K: int, N: int, sms: int = 132):
    """K7's small-M split of the K/2 packed rows: (splits, slice), at most
    8 blocks of one cluster, each over ``slice`` packed rows, a multiple of
    16 (32 input features: whole 16-byte copies of x in f32 or bf16), the
    last slice ragged. Enough splits for about two blocks an SM of the
    (N/32) x (M/16) output tiles, and for slices of at most 512 rows."""
    n_half = K // 2
    tiles = -(-N // INT4_TILE_N) * -(-M // INT4_TILE_M)
    want = max(-(-2 * sms // tiles), -(-n_half // INT4_MAX_SLICE))
    splits = max(1, min(INT4_MAX_SPLIT, want, -(-n_half // 16)))
    slice_r = -(-(-(-n_half // splits)) // 16) * 16
    return -(-n_half // slice_r), slice_r


def int4_small_smem(slice_r: int, rows_per_group: int, n_half: int,
                    x_bytes: int) -> int:
    """Shared memory of a split-K block (``int4_small_smem`` in the
    source): its scales' group rows, 16 rows of x, the packed weights; at
    least the warps' partial sums, 2 KB a warp."""
    groups = min(n_half // rows_per_group, (slice_r - 1) // rows_per_group + 2)
    staged = (groups * INT4_TILE_N * 4 + INT4_TILE_M * 2 * slice_r * x_bytes
              + slice_r * INT4_TILE_N)
    return max(staged, INT4_THREADS // 32 * INT4_TILE_M * INT4_TILE_N * 4)


def int4_uses_split_k(M: int, K: int, N: int, rows_per_group: int,
                      x_bytes: int, sms: int = 132) -> bool:
    """Whether K7 takes its split-K body: M <= 64 and the slice's staging
    fits a block's shared memory."""
    if M > INT4_SMALL_M_MAX:
        return False
    _, slice_r = int4_split_plan(M, K, N, sms)
    return int4_small_smem(slice_r, rows_per_group, K // 2, x_bytes) <= INT4_SMEM_MAX


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _int4_launch(M: int, K: int, N: int, rows_per_group: int, x_bytes: int,
                 sms: int):
    """(splits, slice) of the split-K body, or None for the warps-split
    body; cached, as the decode loop asks for the same few shapes."""
    if int4_uses_split_k(M, K, N, rows_per_group, x_bytes, sms):
        return int4_split_plan(M, K, N, sms)
    return None


def int4_matmul(x, w_q4, w_s4):
    """K7 wrapper: (..., K) f32/bf16 x packed int4 (K/2, N) + group scales
    (K/G, N) f32 -> (..., N) f32.

    CUDA tensors run the kernel (one launch: the split-K body for up to
    64 rows, else the warps-split body), CPU tensors the plain version.
    """
    K = x.shape[-1]
    if w_q4.dtype != torch.int8 or w_q4.dim() != 2 or 2 * w_q4.shape[0] != K:
        raise ValueError(f"w_q4 must be int8 ({K // 2}, N), got {w_q4.dtype} "
                         f"{tuple(w_q4.shape)}")
    n_half, N = w_q4.shape
    groups = w_s4.shape[0]
    if (w_s4.dim() != 2 or w_s4.shape[1] != N or w_s4.dtype != torch.float32
            or groups == 0 or n_half % groups):
        raise ValueError("w_s4 must be f32 (G, N) with G dividing K/2")
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_q4, w_s4)
    _check_cuda("int4_matmul", x, w_q4, w_s4)
    xr, wq, ws = _rows(x).contiguous(), w_q4.contiguous(), w_s4.contiguous()
    M = xr.shape[0]
    rows_per_group = n_half // groups
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = _int4_launch(M, K, N, rows_per_group, 2 if is_bf16 else 4,
                        _sm_count(x.device.index))
    if plan is not None:
        splits, slice_r = plan
        fn = _build.entry("quant_matmul", "wipa_int4_matmul_small",
                          [_build.P] * 4 + [_build.I] * 8 + [_build.P])
        rc = fn(xr.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), M,
                K, N, rows_per_group, splits, slice_r, is_bf16, x.device.index,
                stream)
    else:
        fn = _build.entry("quant_matmul", "wipa_int4_matmul",
                          [_build.P] * 4 + [_build.I] * 6 + [_build.P])
        rc = fn(xr.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), M,
                K, N, rows_per_group, is_bf16, x.device.index, stream)
    _build.check(rc, "wipa_int4_matmul")
    int4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


int4_matmul.launches = 0
