"""PyTorch port: the bf16 design of the tensor-core attention kernels (K2/K10
forward on wgmma, K5 backward on mma.sync) pinned against the JAX package.

The kernels run only on the card. What they compute is emulated here in
torch, in their order and at their rounding points: both scale q and round
it to bf16 first (q * scale in q's dtype, as the TPU kernels and the plain
versions do); the forward walks the keys in 64-key tiles with a running
maximum, rounds each tile's probabilities to bf16 before the value
product, sums in fp32 and divides by the unrounded row sum once; the
backward recomputes P from the forward's log-sum-exp, walks (64-query,
64-key) tile pairs, rounds P and dS to bf16 before their products, takes
dK against the scaled q and multiplies dQ by the scale in fp32 at the end. The emulation and the plain versions (``attention_plain``,
``attention_backward_plain``) in bf16 are both held against the JAX
package's Pallas kernels in interpret mode (``fused_attention``,
``_flash_attention_bwd_impl``) on the same bf16 inputs, made from a seed
with numpy.

Bounds:
- forward, 5e-3 absolute, or one bf16 ulp of the value where that is
  larger: the two sides round P at slightly different values (the JAX
  kernel also rounds the scale itself to bf16) and sum in another order,
  so a rounding of the output may fall the other way, which costs up to
  3.9e-3 below 1 and 2^-7 at or above it;
- backward, 1e-2 relative to each gradient's max: P and dS are rounded to
  bf16 (one ulp 2^-8 = 3.9e-3 relative) at values that differ a little
  between the sides (the JAX kernel rounds g / denom instead of P), and
  each gradient sums up to T such terms.
The card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold
the kernels to their plain versions at the same bounds.
"""

import math
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.ops.attention import _flash_attention_bwd_impl
from whisper_ipa_tpu.ops.attention import fused_attention as jax_fused_attention
from whisper_ipa_torch.ops import _build
from whisper_ipa_torch.ops import attention_backward_plain, attention_plain

torch.set_num_threads(1)

TILE = 64
LOG2E = 1.0 / math.log(2.0)
FWD_ATOL = 5e-3
BWD_RTOL = 1e-2


def _fwd_close(got, want) -> bool:
    """Every element within FWD_ATOL, or within one bf16 ulp of ``want``
    where that is larger (an output at or above 1 whose fp32 sums round to
    the neighbouring bf16 value is 2^-7 off)."""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((got - want).abs() <= ulp.clamp_min(FWD_ATOL)).all())


def emulate_forward(q, k, v, scale: float):
    """The bf16 K2/K10 kernel's arithmetic on (..., T, Dh) bf16 operands:
    (out bf16, lse f32)."""
    qf = (q.float() * scale).bfloat16().float()  # the scaled Q tile
    kf, vf = k.float(), v.float()
    c = LOG2E
    shape = qf.shape[:-1] + (1,)
    m = torch.full(shape, -math.inf)  # running max of c * s
    l = torch.zeros(shape)
    o = torch.zeros(qf.shape)
    for k0 in range(0, k.shape[-2], TILE):
        s = qf @ kf[..., k0:k0 + TILE, :].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + p.bfloat16().float() @ vf[..., k0:k0 + TILE, :]
        m = m_new
    lse = (m / LOG2E + torch.log(l)).squeeze(-1)
    return (o / l).bfloat16(), lse


def emulate_backward(q, k, v, out, g, lse, scale: float):
    """The bf16 K5 kernel's arithmetic: (dq, dk, dv) in bf16 from the
    forward's output and log-sum-exp."""
    qf = (q.float() * scale).bfloat16().float()  # the scaled Q tiles
    kf, vf, gf = k.float(), v.float(), g.float()
    delta = (out.float() * gf).sum(-1, keepdim=True)
    c = LOG2E
    l2 = lse.unsqueeze(-1) * LOG2E
    dq, dk, dv = torch.zeros(qf.shape), torch.zeros(kf.shape), torch.zeros(vf.shape)
    for q0 in range(0, q.shape[-2], TILE):
        qs = slice(q0, q0 + TILE)
        for k0 in range(0, k.shape[-2], TILE):
            ks = slice(k0, k0 + TILE)
            s = qf[..., qs, :] @ kf[..., ks, :].transpose(-1, -2)
            p = torch.exp2(s * c - l2[..., qs, :])
            dp = gf[..., qs, :] @ vf[..., ks, :].transpose(-1, -2)
            ds = (p * (dp - delta[..., qs, :])).bfloat16().float()
            p = p.bfloat16().float()
            dv[..., ks, :] += p.transpose(-1, -2) @ gf[..., qs, :]
            dk[..., ks, :] += ds.transpose(-1, -2) @ qf[..., qs, :]
            dq[..., qs, :] += ds @ kf[..., ks, :]
    return (dq * scale).bfloat16(), dk.bfloat16(), dv.bfloat16()


def _inputs(tq, tk, heads, dh, n, seed):
    """n unit-normal bf16 operands, (1, heads, t, dh), t = tq for the first
    and, for the backward's g, the last; the same values for JAX and torch."""
    rng = np.random.default_rng(seed)
    lens = [tq, tk, tk, tq][:n]
    arrays = [rng.standard_normal((1, heads, t, dh)).astype(np.float32) for t in lens]
    return ([torch.from_numpy(a).bfloat16() for a in arrays],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays])


# (Tq, Tk, heads): a partial query tile against a ragged key tail, keys
# past one tile, and the encoder's 1500 (no multiple of 64) with one head
SHAPES = [(130, 257, 2), (256, 300, 2), (1500, 1500, 1)]


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk,heads", SHAPES)
def test_forward_design_matches_pallas(tq, tk, heads, dh):
    (q, k, v), jx = _inputs(tq, tk, heads, dh, 3, seed=tq + dh)
    scale = dh ** -0.5
    ref = torch.from_numpy(np.array(jax_fused_attention(*jx, scale, True)
                                    .astype(jnp.float32)))
    emu, lse = emulate_forward(q, k, v, scale)
    plain = attention_plain(q, k, v, scale)
    assert emu.shape == plain.shape == ref.shape and emu.dtype == torch.bfloat16
    assert _fwd_close(emu, ref) and _fwd_close(plain, ref)
    assert _fwd_close(emu, plain)
    # the log-sum-exp of the logits the kernel forms, from the scaled q in bf16
    qs = (q.float() * scale).bfloat16().float()
    want_lse = torch.logsumexp(qs @ k.float().transpose(-1, -2), -1)
    assert (lse - want_lse).abs().max().item() < 1e-4


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("tq,tk,heads", SHAPES)
def test_backward_design_matches_pallas(tq, tk, heads, dh):
    (q, k, v, g), jx = _inputs(tq, tk, heads, dh, 4, seed=7 + tq + dh)
    scale = dh ** -0.5
    ref = _flash_attention_bwd_impl(*jx, scale, interpret=True)
    ref = [np.asarray(r.astype(jnp.float32)) for r in ref]
    out, lse = emulate_forward(q, k, v, scale)
    emu = emulate_backward(q, k, v, out, g, lse, scale)
    plain = attention_backward_plain(q, k, v, g, scale)
    for name, e, p, r in zip(("dq", "dk", "dv"), emu, plain, ref):
        assert e.shape == p.shape == r.shape and e.dtype == torch.bfloat16, name
        top = np.max(np.abs(r))
        assert np.max(np.abs(e.float().numpy() - r)) < BWD_RTOL * top, name
        assert np.max(np.abs(p.float().numpy() - r)) < BWD_RTOL * top, name
        top = p.float().abs().max().item()
        assert (e.float() - p.float()).abs().max().item() < BWD_RTOL * top, name


def test_header_edit_renames_library(tmp_path, monkeypatch):
    """A library's file name hashes its source and every shared header, so
    an edited header rebuilds each library instead of loading a stale one."""
    for src in _build.CSRC_DIR.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    headers = sorted(tmp_path.glob("*.cuh"))
    assert headers, "the kernels share a header"
    before = {n: _build._library_path(n) for n in _build.KERNEL_SOURCES}
    assert before == {n: _build._library_path(n) for n in _build.KERNEL_SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.KERNEL_SOURCES}
    assert all(after[n] != before[n] for n in _build.KERNEL_SOURCES)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())
