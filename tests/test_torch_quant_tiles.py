"""PyTorch port: the tensor-core designs of K3 (fused int8 cross-KV build,
bf16 body on wgmma) and K6 (int8 x int8 product on mma.sync s8) pinned
against the JAX package.

The kernels run only on the card. What they compute is emulated here in
torch and numpy, in their order and at their rounding points, on inputs
made from a seed with numpy:

- K3 (bf16): bf16 operands; each 64-feature k-tile summed in f32 16
  features at a time (its wgmma k-steps) into a fresh partial, which is
  added to the running f32 sum; then ``linear()``'s two
  roundings (the product to bf16, plus the pre-rounded bias, to bf16
  again) and the (position, head) quantizer. Held, with the bf16 plain
  version, against the TPU kernel in interpret mode at
  ``tests/test_torch_quant_ops.py``'s bounds for the plain version: scales
  rtol 1e-6, codes within 1 and more than 99.9% equal.
- K6: the row codes and scales of the plain version, int32 partial sums
  over the kernel's K slices (``split_k_plan`` for M <= 64, 128-code tiles
  above), added in int32 and rescaled in f32 as ``float(acc) * s[m] *
  w_scale[n]``. The integer sums are exact in any split, so the emulation
  equals ``int8_matmul_plain`` bit for bit; against the TPU kernel in
  interpret mode the bound is 1e-6 of max|y| (XLA's CPU divides by 127 as
  a product with the reciprocal, an ulp off the IEEE quotient).
The card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold the
kernels to their plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.ops import quant as jax_quant
from whisper_ipa_tpu.ops.kv_init import fused_kv_init_int8 as jax_kv_init
from whisper_ipa_tpu.ops.quant_matmul import int8_matmul as jax_int8_matmul
from whisper_ipa_torch.ops import fused_kv_init_plain, int8_matmul_plain
from whisper_ipa_torch.ops.kv_init import _bias_f32, quantize_kv_heads
from whisper_ipa_torch.ops.precision import div_ieee
from whisper_ipa_torch.ops.quant_matmul import SMALL_M_MAX, split_k_plan

torch.set_num_threads(1)

K_STEP = 16   # features a wgmma k-step (K3)
K3_TILE = 64  # features a k-tile (K3)
K_TILE = 128  # codes a tile of K6's large-M body


# -- K3 -------------------------------------------------------------------------

def emulate_kv_init_bf16(x, wk, bk, wv, bv, n_head: int):
    """K3's bf16 body on (B, T, d_in) x and (d_in, d) weights."""
    xb = x.bfloat16().float()
    outs = []
    for w, b in ((wk, bk), (wv, bv)):
        wb = w.bfloat16().float()
        acc = torch.zeros(x.shape[:-1] + (w.shape[1],))
        for t0 in range(0, x.shape[-1], K3_TILE):
            part = torch.zeros_like(acc)
            for k0 in range(t0, t0 + K3_TILE, K_STEP):
                part = part + xb[..., k0:k0 + K_STEP] @ wb[k0:k0 + K_STEP]
            acc = acc + part
        y = acc.bfloat16().float() + _bias_f32(b, w.shape[1], torch.bfloat16, x.device)
        outs.extend(quantize_kv_heads(y.bfloat16(), n_head))
    return tuple(outs)


def _assert_kv_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.numpy().dtype == w.dtype
    for i in (1, 3):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=1e-6, atol=1e-9)
    for i in (0, 2):
        diff = np.abs(got[i].numpy().astype(np.int32) - want[i].astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


@pytest.mark.parametrize("T", [150, 64])
@pytest.mark.parametrize("d,H", [(64, 2), (128, 2)])  # Dh 32, Dh 64
def test_kv_init_bf16_design_matches_pallas(d, H, T):
    rng = np.random.default_rng(d + T)
    x = (rng.standard_normal((2, T, d)) * 0.5).astype(np.float32)
    wk, wv = ((rng.standard_normal((d, d)) * 0.1).astype(np.float32) for _ in range(2))
    bv = (rng.standard_normal((d,)) * 0.1).astype(np.float32)
    ref = jax_kv_init(jnp.asarray(x), jnp.asarray(wk), None, jnp.asarray(wv),
                      jnp.asarray(bv), H, out_dtype=jnp.bfloat16, interpret=True)
    ref = [np.asarray(r) for r in ref]
    t = [torch.from_numpy(a) for a in (x, wk, wv, bv)]
    emu = emulate_kv_init_bf16(t[0], t[1], None, t[2], t[3], H)
    plain = fused_kv_init_plain(t[0], t[1], None, t[2], t[3], H, torch.bfloat16)
    _assert_kv_close(emu, ref)
    _assert_kv_close(plain, ref)
    t_pad = ref[0].shape[-1]
    assert t_pad % 128 == 0 and np.all(emu[1].numpy()[..., T:] == 0)
    assert np.all(emu[0].numpy()[..., T:] == 0) and np.all(emu[1].numpy()[..., :T] > 0)


# -- K6 -------------------------------------------------------------------------

def _codes(x):
    """The plain version's row scales and codes (as int32 numpy)."""
    xf = x.reshape(-1, x.shape[-1]).float()
    s = div_ieee(torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-6), 127.0)
    return s, torch.clamp(torch.round(xf / s), -127, 127).numpy().astype(np.int32)


def kernel_slices(M: int, K: int):
    """The K ranges whose int32 partial sums K6 adds: the cluster's slices
    at M <= SMALL_M_MAX, else the 128-code tiles."""
    if M <= SMALL_M_MAX:
        splits, size = split_k_plan(K)
    else:
        splits, size = -(-K // K_TILE), K_TILE
    return [(q * size, min(K, (q + 1) * size)) for q in range(splits)]


def emulate_int8_matmul(x, w_q, w_scale):
    s, xq = _codes(x)
    wq = w_q.numpy().astype(np.int32)
    acc = np.zeros((xq.shape[0], wq.shape[1]), np.int32)
    for lo, hi in kernel_slices(*xq.shape):
        acc += xq[:, lo:hi] @ wq[lo:hi]  # int32 throughout: exact
    return torch.from_numpy(acc).float() * s * w_scale


def test_split_k_plan_covers_k():
    """Slices of a multiple of 32 codes, at most 8, every code in one; at
    the decode shapes at least ~132 blocks of 32 columns stream the weights."""
    for K in (4, 100, 384, 768, 900, 1536, 3072, 5120):
        splits, size = split_k_plan(K)
        assert 1 <= splits <= 8 and size % 32 == 0
        assert splits * size >= K > (splits - 1) * size
    for K, N in ((768, 768), (768, 3072), (3072, 768)):
        assert -(-N // 32) * split_k_plan(K)[0] >= 132


@pytest.mark.parametrize("K", [768, 3072])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 130])
def test_int8_split_k_design_matches_plain_and_pallas(M, K):
    rng = np.random.default_rng(M + K)
    N = 96
    x = (rng.standard_normal((M, K)) * 0.7).astype(np.float32)
    x[0] = 0.0  # an all-zero row: scale floor 1e-6 / 127
    q = jax_quant.quantize_linear({"w": jnp.asarray(
        (rng.standard_normal((K, N)) * 0.1).astype(np.float32))})
    w_q, w_s = torch.from_numpy(np.array(q["w_q"])), torch.from_numpy(np.array(q["w_s"]))
    for xt in (torch.from_numpy(x), torch.from_numpy(x).bfloat16()):
        emu = emulate_int8_matmul(xt, w_q, w_s)
        assert torch.equal(emu, int8_matmul_plain(xt, w_q, w_s))
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), q["w_q"], q["w_s"], interpret=True))
    got = emulate_int8_matmul(torch.from_numpy(x), w_q, w_s).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))


@pytest.mark.parametrize("M", [2, 100])
def test_int8_split_k_design_sums_past_2_24(M):
    """K = 3072 (mlp2): a row's sum passes 2^24, which f32 sums would
    round; the int32 partials stay exact (an int64 reference)."""
    K = 3072
    x = torch.full((M, K), 1.0)
    x[1, ::2] = -1.0
    w_q = torch.full((K, 3), 127, dtype=torch.int8)
    w_q[::3, 1] = -127
    out = emulate_int8_matmul(x, w_q, torch.ones(3))
    xq = torch.round(x / (1.0 / 127)).clamp(-127, 127).long()
    exact = (xq @ w_q.long()).float() * (1.0 / 127)
    assert abs(int((xq @ w_q.long())[0, 0])) > 2 ** 24
    assert torch.equal(out, exact) and torch.equal(out, int8_matmul_plain(x, w_q, torch.ones(3)))
