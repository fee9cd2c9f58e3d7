"""PyTorch port: the one-launch designs of K4 and K8 (int8 and int4
single-query cross-attention, T split over a thread-block cluster) and K7
(int4-weight product, K split over a cluster) pinned against the plain
versions and the JAX package.

The kernels run only on the card. Their launch plans are plain Python
(``decode_attention.k4_split_plan`` and ``k8_split_plan``;
``quant_matmul.int4_split_plan`` and ``int4_uses_split_k``) and are checked
here for every shape the serving paths and the card tests use. The order
in which each kernel sums is emulated in torch on inputs made from a seed
with numpy:

- K4: each block's slice gives (max, row sum, acc[Dh]) in f32: the logits
  as 16-dim groups of q . k added in order, times the K scale, -inf where
  it is 0; exp against the slice's max; the V scale folded into the
  probabilities. The cluster merges the slices, each rescaled by
  exp(max_s - max), and divides once. Held against
  ``decode_attention_plain`` and the TPU kernel in interpret mode in f32 at
  rtol = atol = 1e-5, and against the bf16 plain version at 2% of
  max|out|: the card tests' bounds.
- K8: K4's body over the nibble-packed codes, the last slice possibly
  shorter; the codes widened by K8's offset-binary trick (XOR 0x88888888,
  nibble masks, each byte as the low mantissa byte of 2^23), checked
  against sign extension for all 256 bytes. Held against
  ``decode_attention_int4_plain`` in f32 at rtol = atol = 1e-5 and the TPU
  kernel in interpret mode (which wants T_pad % 256 == 0) likewise, and
  against the bf16 plain version at 1e-2 of max|out|: the card tests'
  bounds.
- K7: f32 partial sums over each K slice of packed rows, the codes
  dequantized as the plain version does (code * scale in f32), added in
  rank order. Held against ``int4_matmul_plain`` and the TPU kernel in
  interpret mode at 1e-5 of max|y|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.ops import quant as jax_quant
from whisper_ipa_tpu.ops.decode_attention import (
    decode_cross_attention_int8_tminor as jax_decode_int8,
)
from whisper_ipa_tpu.ops.quant_matmul import int4_matmul as jax_int4_matmul
from whisper_ipa_tpu.ops.decode_attention import (
    decode_cross_attention_int4_tminor as jax_decode_int4,
)
from whisper_ipa_torch.ops import (
    decode_attention_int4_plain,
    decode_attention_plain,
    int4_matmul_plain,
)
from whisper_ipa_torch.ops.decode_attention import (
    K8_MAX_SLICE,
    k4_split_plan,
    k8_split_plan,
)
from whisper_ipa_torch.ops.quant import unpack_nibbles
from whisper_ipa_torch.ops.quant_matmul import (
    INT4_SMALL_M_MAX,
    INT4_TILE_M,
    INT4_TILE_N,
    int4_halves,
    int4_split_plan,
    int4_uses_split_k,
)

torch.set_num_threads(1)

SMS = 132  # the H100's multiprocessors


# -- K4 ---------------------------------------------------------------------------

def emulate_cluster(q, kf, k_scale, vf, v_scale, splits, size):
    """The cluster body shared by K4 and K8 on (B, H, 1, Dh) q, (B, H, Dh,
    T_pad) f32 codes in position order and (B, H, T_pad) scales, block r
    over positions [r * size, min((r + 1) * size, T_pad)) -> (B, H, 1, Dh)
    in q's dtype."""
    dh = q.shape[-1]
    t_pad = k_scale.shape[-1]
    qf = q.float()[:, :, 0, :]
    slices = []
    for r in range(splits):
        t = slice(r * size, min((r + 1) * size, t_pad))
        s = None
        for g in range(dh // 16):
            d = slice(16 * g, 16 * g + 16)
            part = torch.einsum("bhd,bhdt->bht", qf[..., d], kf[:, :, d, t])
            s = part if s is None else s + part
        sc = k_scale[..., t]
        logits = torch.where(sc > 0.0, s * sc, float("-inf"))
        m = logits.amax(-1)
        e = torch.where(logits == float("-inf"), 0.0, torch.exp(logits - m[..., None]))
        p = e * v_scale[..., t]
        slices.append((m, e.sum(-1), torch.einsum("bht,bhdt->bhd", p, vf[..., t])))
    mx = torch.stack([m for m, _, _ in slices]).amax(0)
    num = torch.zeros_like(slices[0][2])
    den = torch.zeros_like(slices[0][1])
    for m, l, acc in slices:
        w = torch.where(m == float("-inf"), 0.0, torch.exp(m - mx))
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / den[..., None])[:, :, None, :].to(q.dtype)


def emulate_k4(q, k, k_scale, v, v_scale):
    """K4's cluster design on (B, H, Dh, T_pad) int8 codes."""
    splits, size = k4_split_plan(k_scale.shape[-1])
    return emulate_cluster(q, k.float(), k_scale, v.float(), v_scale, splits, size)


def _int8_cache(B, H, dh, T, t_pad, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (B, H, dh, t_pad)).astype(np.int8)
    v = rng.integers(-127, 128, (B, H, dh, t_pad)).astype(np.int8)
    ks = (0.01 + 0.02 * rng.random((B, H, t_pad))).astype(np.float32)
    vs = (0.01 + 0.02 * rng.random((B, H, t_pad))).astype(np.float32)
    ks[..., T:] = 0.0  # padded positions
    vs[..., T:] = 0.0
    q = (rng.standard_normal((B, H, 1, dh)) * dh ** -0.5).astype(np.float32)
    return q, k, ks, v, vs


def test_k4_split_plan_covers_t():
    """A cluster of at most 8 blocks a (b, h), slices of a multiple of 16
    positions (16-byte copies of the codes, four f32 scales), of 128 to
    1024 positions; every (b, h, position) in exactly one block, for T_pad
    128-8192 and B * H 1-192; 1152 blocks of 256 positions at the
    main-path shape."""
    for t_pad in range(128, 8192 + 1, 128):
        splits, size = k4_split_plan(t_pad)
        assert 1 <= splits <= 8 and size % 16 == 0 and 128 <= size <= 1024
        assert splits * size == t_pad
    for bh in (1, 12, 192):
        for t_pad in (128, 384, 1536):
            splits, size = k4_split_plan(t_pad)
            seen = np.zeros((bh, t_pad), np.int32)
            for block in range(splits * bh):  # the grid: cluster = (b, h)
                c, rank = divmod(block, splits)
                seen[c, rank * size:(rank + 1) * size] += 1
            assert (seen == 1).all()
    assert k4_split_plan(1536) == (6, 256)
    for bad in (0, 100, 8192 + 128):
        with pytest.raises(ValueError):
            k4_split_plan(bad)


@pytest.mark.parametrize("B,H,dh,T,t_pad", [
    (2, 3, 64, 1500, 1536),  # whisper-small's cache, 6 slices of 256
    (1, 2, 32, 32, 128),     # test-tiny: one slice, mostly padding
    (2, 3, 32, 200, 1024),   # 4 slices, three all padding
    (1, 1, 64, 700, 640),    # no padding, 2 slices of 320
])
def test_k4_design_matches_plain_and_pallas(B, H, dh, T, t_pad):
    T = min(T, t_pad)
    arrays = _int8_cache(B, H, dh, T, t_pad, seed=B * t_pad + dh)
    q, k, ks, v, vs = (torch.from_numpy(a) for a in arrays)
    emu = emulate_k4(q, k, ks, v, vs)
    assert emu.shape == (B, H, 1, dh) and bool(torch.isfinite(emu).all())
    torch.testing.assert_close(emu, decode_attention_plain(q, k, ks, v, vs),
                               rtol=1e-5, atol=1e-5)
    ref = np.asarray(jax_decode_int8(*[jnp.asarray(a) for a in arrays],
                                     interpret=True))
    np.testing.assert_allclose(emu.numpy(), ref, rtol=1e-5, atol=1e-5)
    qb = q.bfloat16()
    got, want = emulate_k4(qb, k, ks, v, vs), decode_attention_plain(qb, k, ks, v, vs)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 0.02 * want.float().abs().max().item()


def test_k4_design_all_masked_row_is_nan():
    """A (b, h) whose every scale is 0 gives 0/0 = NaN, as the plain
    version's softmax over -inf does; its neighbours are untouched."""
    arrays = _int8_cache(1, 2, 32, 100, 256, seed=3)
    arrays[2][0, 1] = 0.0
    q, k, ks, v, vs = (torch.from_numpy(a) for a in arrays)
    emu, want = emulate_k4(q, k, ks, v, vs), decode_attention_plain(q, k, ks, v, vs)
    assert bool(torch.isnan(emu[0, 1]).all()) and bool(torch.isnan(want[0, 1]).all())
    torch.testing.assert_close(emu[0, 0], want[0, 0], rtol=1e-5, atol=1e-5)


# -- K8 ---------------------------------------------------------------------------

def widen_nibbles(words: np.ndarray):
    """K8's widening of uint32 words of packed codes, bit for bit: (lo, hi)
    (n, 4) f32, lo[:, j] the low nibble of byte j (position 2j of the
    word), hi[:, j] the high one (2j + 1)."""
    u = words ^ np.uint32(0x88888888)
    planes = []
    for x in (u & np.uint32(0x0F0F0F0F), (u >> np.uint32(4)) & np.uint32(0x0F0F0F0F)):
        cols = []
        for j in range(4):
            byte = (x >> np.uint32(8 * j)) & np.uint32(0xFF)
            bits = (np.uint32(0x4B000000) | byte).astype(np.uint32)
            cols.append(bits.view(np.float32) - np.float32(8388616.0))  # 2^23 + 8
        planes.append(np.stack(cols, axis=-1))
    return planes[0], planes[1]


def _positions(packed):
    """(B, H, Dh, T_pad / 2) packed codes -> (B, H, Dh, T_pad) f32 in
    position order (a byte's low nibble first)."""
    lo, hi = unpack_nibbles(packed, torch.float32)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def emulate_k8(q, k_p4, k_scale, v_p4, v_scale, plan_bh=None):
    """K8's cluster design on (B, H, Dh, T_pad / 2) nibble-packed codes, at
    the split the wrapper takes for q's B * H on 132 SMs, or for
    ``plan_bh``."""
    bh = plan_bh or q.shape[0] * q.shape[1]
    splits, size = k8_split_plan(k_scale.shape[-1], bh)
    return emulate_cluster(q, _positions(k_p4), k_scale, _positions(v_p4),
                           v_scale, splits, size)


def _int4_cache(B, H, dh, T, t_pad, seed):
    rng = np.random.default_rng(seed)
    # any byte: two codes in -8..7 (the quantizer emits -7..7)
    k = rng.integers(-128, 128, (B, H, dh, t_pad // 2)).astype(np.int8)
    v = rng.integers(-128, 128, (B, H, dh, t_pad // 2)).astype(np.int8)
    ks = (0.1 + 0.2 * rng.random((B, H, t_pad))).astype(np.float32)
    vs = (0.1 + 0.2 * rng.random((B, H, t_pad))).astype(np.float32)
    ks[..., T:] = 0.0  # padded positions
    vs[..., T:] = 0.0
    q = (rng.standard_normal((B, H, 1, dh)) * dh ** -0.5).astype(np.float32)
    return q, k, ks, v, vs


def test_k8_split_plan_covers_t():
    """A cluster of at most 8 blocks a (b, h), slices of a multiple of 32
    positions (whole 16-byte copies of a packed row segment) of at most
    2048, the last possibly shorter but never empty; every (b, h,
    position) in exactly one block, for T_pad 128-12288 and B * H 1-192;
    at the main-path T_pad 1536, two slices of 768 where B * H fills the
    SMs (192, 48) and six of 256 where it does not (12, 1)."""
    for bh in (1, 12, 48, 192):
        for t_pad in range(128, 12288 + 1, 128):
            splits, size = k8_split_plan(t_pad, bh)
            assert 1 <= splits <= 8 and size % 32 == 0
            assert 32 <= size <= K8_MAX_SLICE
            assert (splits - 1) * size < t_pad <= splits * size
            assert (t_pad // 2 - (splits - 1) * size // 2) % 16 == 0  # last
        for t_pad in (128, 640, 1536, 12160):
            splits, size = k8_split_plan(t_pad, bh)
            seen = np.zeros((bh, t_pad), np.int32)
            for block in range(splits * bh):  # the grid: cluster = (b, h)
                c, rank = divmod(block, splits)
                seen[c, rank * size:min(t_pad, (rank + 1) * size)] += 1
            assert (seen == 1).all()
    assert k8_split_plan(1536, 192) == k8_split_plan(1536, 48) == (2, 768)
    assert k8_split_plan(1536, 12) == k8_split_plan(1536, 1) == (6, 256)
    assert k8_split_plan(1536, 12, sms=16) == (2, 768)
    for bad in (0, 100, 8 * K8_MAX_SLICE + 128):
        with pytest.raises(ValueError):
            k8_split_plan(bad, 192)


def test_k8_widening_equals_sign_extension():
    """All 256 byte values, both nibbles: XOR 8, mask, 2^23's mantissa,
    less 2^23 + 8, gives the two's-complement code exactly, and a word's
    eight floats come out in position order."""
    data = np.arange(256, dtype=np.uint8)
    lo, hi = widen_nibbles(data.view(np.uint32))
    signed = data.view(np.int8).astype(np.int32)
    np.testing.assert_array_equal(lo.reshape(-1), ((signed & 15) ^ 8) - 8)
    np.testing.assert_array_equal(hi.reshape(-1), signed >> 4)
    order = np.stack([lo, hi], axis=-1).reshape(-1)  # word: lo0 hi0 lo1 hi1 ..
    want = _positions(torch.from_numpy(data.view(np.int8))[None]).numpy()[0]
    np.testing.assert_array_equal(order, want)


# the split of T at these tensors' own B * H (6: slices of 256) and at the
# main path's (192: slices of 768, at T_pad 2048 three of 704, the last 640)
@pytest.mark.parametrize("plan_bh", [None, 192])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("t_pad,T", [
    (128, 100),    # one slice, test-tiny's padding
    (1536, 1500),  # whisper-small's cache
    (2048, 2000),
])
def test_k8_design_matches_plain_and_pallas(dh, t_pad, T, plan_bh):
    arrays = _int4_cache(2, 3, dh, T, t_pad, seed=t_pad + dh)
    q, k, ks, v, vs = (torch.from_numpy(a) for a in arrays)
    emu = emulate_k8(q, k, ks, v, vs, plan_bh)
    assert emu.shape == (2, 3, 1, dh) and bool(torch.isfinite(emu).all())
    torch.testing.assert_close(emu, decode_attention_int4_plain(q, k, ks, v, vs),
                               rtol=1e-5, atol=1e-5)
    if t_pad % 256 == 0:
        ref = np.asarray(jax_decode_int4(*[jnp.asarray(a) for a in arrays],
                                         interpret=True))
        np.testing.assert_allclose(emu.numpy(), ref, rtol=1e-5, atol=1e-5)
    qb = q.bfloat16()
    got = emulate_k8(qb, k, ks, v, vs, plan_bh)
    want = decode_attention_int4_plain(qb, k, ks, v, vs)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


def test_k8_design_ragged_last_slice():
    """T_pad 12160 splits into 8 slices of 1536, the last 1408: the
    emulation still matches the plain version."""
    splits, size = k8_split_plan(12160, 1)
    assert splits * size > 12160
    arrays = _int4_cache(1, 1, 32, 12000, 12160, seed=5)
    q, k, ks, v, vs = (torch.from_numpy(a) for a in arrays)
    torch.testing.assert_close(emulate_k8(q, k, ks, v, vs),
                               decode_attention_int4_plain(q, k, ks, v, vs),
                               rtol=1e-5, atol=1e-5)


def test_k8_design_all_masked_row_is_nan():
    """A (b, h) whose every scale is 0 gives 0/0 = NaN, as the plain
    version's softmax over -inf does; its neighbours are untouched."""
    arrays = _int4_cache(1, 2, 32, 100, 256, seed=3)
    arrays[2][0, 1] = 0.0
    q, k, ks, v, vs = (torch.from_numpy(a) for a in arrays)
    emu = emulate_k8(q, k, ks, v, vs)
    want = decode_attention_int4_plain(q, k, ks, v, vs)
    assert bool(torch.isnan(emu[0, 1]).all()) and bool(torch.isnan(want[0, 1]).all())
    torch.testing.assert_close(emu[0, 0], want[0, 0], rtol=1e-5, atol=1e-5)


# -- K7 ---------------------------------------------------------------------------

def emulate_k7(x, w_q4, w_s4):
    """K7's split-K body on (M, K) x: f32 sums over each plan slice of
    packed rows, added in rank order -> (M, N) f32."""
    M, K = x.shape
    n_half, N = w_q4.shape
    splits, size = int4_split_plan(M, K, N)
    lo, hi = int4_halves(w_q4, w_s4, torch.float32)
    xf = x.float()
    out = torch.zeros((M, N))
    for r in range(splits):
        a, b = r * size, min(n_half, (r + 1) * size)
        out = out + (xf[:, 2 * a:2 * b:2] @ lo[a:b] + xf[:, 2 * a + 1:2 * b:2] @ hi[a:b])
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_int4_split_plan_covers_k_n_m():
    """For M 1-64 and K, N in {128, 200, 768, 3072}: at most 8 slices, each
    a multiple of 16 packed rows (32 features: whole 16-byte copies of x),
    every packed row in exactly one; 32-column tiles (two 16-byte weight
    copies a row) and 16-row tiles cover N and M once; the split-K body
    serves M <= 64 and the warps-split body M 65."""
    for K in (128, 200, 768, 3072):
        n_half = K // 2
        rpg = n_half // (K // 64 if K % 64 == 0 else K // 8)
        for N in (128, 200, 768, 3072):
            for M in range(1, INT4_SMALL_M_MAX + 1):
                splits, size = int4_split_plan(M, K, N)
                assert 1 <= splits <= 8 and size % 16 == 0
                seen = np.zeros(n_half, np.int32)
                for r in range(splits):
                    seen[r * size:min(n_half, (r + 1) * size)] += 1
                assert (seen == 1).all()
                n_tiles, m_tiles = -(-N // INT4_TILE_N), -(-M // INT4_TILE_M)
                assert (n_tiles - 1) * INT4_TILE_N < N <= n_tiles * INT4_TILE_N
                assert (m_tiles - 1) * INT4_TILE_M < M <= m_tiles * INT4_TILE_M
                for x_bytes in (2, 4):
                    assert int4_uses_split_k(M, K, N, rpg, x_bytes)
            assert not int4_uses_split_k(INT4_SMALL_M_MAX + 1, K, N, rpg, 2)
    # the decode and prefix shapes fill the card: at least 132 blocks
    for M, K, N in ((16, 768, 3072), (16, 3072, 768), (16, 768, 768),
                    (48, 768, 768), (48, 768, 3072), (48, 3072, 768)):
        splits, _ = int4_split_plan(M, K, N, SMS)
        assert -(-N // INT4_TILE_N) * -(-M // INT4_TILE_M) * splits >= SMS


@pytest.mark.parametrize("K,N", [(128, 96), (768, 200), (3072, 96)])
@pytest.mark.parametrize("M", [1, 16, 48, 64])
def test_int4_split_k_design_matches_plain_and_pallas(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = jax_quant.quantize_linear_int4({"w": jnp.asarray(
        (rng.standard_normal((K, N)) * 0.1).astype(np.float32))})
    w_q4 = torch.from_numpy(np.array(q["w_q4"]))
    w_s4 = torch.from_numpy(np.array(q["w_s4"]))
    for xt in (torch.from_numpy(x), torch.from_numpy(x).bfloat16()):
        emu = emulate_k7(xt, w_q4, w_s4)
        assert emu.dtype == torch.float32 and emu.shape == (M, N)
        assert _rel(emu.numpy(), int4_matmul_plain(xt, w_q4, w_s4).numpy()) <= 1e-5
    ref = np.asarray(jax_int4_matmul(jnp.asarray(x), q["w_q4"], q["w_s4"],
                                     interpret=True))
    assert _rel(emulate_k7(torch.from_numpy(x), w_q4, w_s4).numpy(), ref) <= 1e-5


def test_int4_split_k_design_ragged_groups():
    """K = 200: the quantizer's groups are 8 features (4 packed rows), so
    the slices of 16 packed rows span several groups and the last is
    ragged (100 rows); the emulation still matches the plain version."""
    rng = np.random.default_rng(7)
    K, N = 200, 200
    x = torch.from_numpy(rng.standard_normal((16, K)).astype(np.float32))
    q = jax_quant.quantize_linear_int4({"w": jnp.asarray(
        (rng.standard_normal((K, N)) * 0.1).astype(np.float32))})
    w_q4 = torch.from_numpy(np.array(q["w_q4"]))
    w_s4 = torch.from_numpy(np.array(q["w_s4"]))
    assert w_q4.shape[0] // w_s4.shape[0] == 4
    splits, size = int4_split_plan(16, K, N)
    assert splits > 1 and (K // 2) % size
    assert _rel(emulate_k7(x, w_q4, w_s4).numpy(),
                int4_matmul_plain(x, w_q4, w_s4).numpy()) <= 1e-5
