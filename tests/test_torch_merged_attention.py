"""PyTorch port: K10, head-merged encoder attention, on the CPU.

The port's counterpart of ``tests/test_pallas_attention.py``'s
``TestMergedAttention``: ``fused_attention_merged`` (its plain version on
the CPU) against the JAX package's ``fused_attention_merged`` in Pallas
interpret mode, the in-kernel scale, the gradients of the autograd
Function (K5's plain version on split heads here) against ``jax.grad``,
the ``use_merged_attention`` dispatch in ``models/layers``, and the
``WHISPER_IPA_TPU_MERGED_ATTN`` switch read at import. The CUDA kernel is
held against its plain version and against K2 on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_ipa_tpu.ops.attention import _xla_attention
from whisper_ipa_tpu.ops.attention import (
    fused_attention_merged as jax_fused_attention_merged,
)
from whisper_ipa_torch.models import layers
from whisper_ipa_torch.ops import attention as at

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("tq,tk,n_head", [(256, 256, 4), (130, 257, 2)])
def test_merged_plain_matches_pallas_interpret(tq, tk, n_head):
    """f32 within 2e-5, the bound of the JAX package's own test."""
    d = 64 * n_head
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, tq, d)).astype(np.float32) * 0.3
    k = rng.standard_normal((2, tk, d)).astype(np.float32) * 0.3
    v = rng.standard_normal((2, tk, d)).astype(np.float32)
    s4 = 64 ** -0.25  # per-operand scale, dh**-0.5 on the logits
    want = np.asarray(jax_fused_attention_merged(
        jnp.asarray(q * s4), jnp.asarray(k * s4), jnp.asarray(v), n_head,
        interpret=True,
    ))
    got = at.fused_attention_merged(_t(q * s4), _t(k * s4), _t(v), n_head)
    assert tuple(got.shape) == want.shape
    assert np.max(np.abs(got.numpy() - want)) < 2e-5
    plain = at.attention_merged_plain(_t(q * s4), _t(k * s4), _t(v), n_head)
    assert torch.equal(got, plain)


def test_in_kernel_scale():
    """The scale applied to q inside == pre-scaled q, within 2e-6."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 130, 128)).astype(np.float32)
    k = rng.standard_normal((1, 200, 128)).astype(np.float32)
    v = rng.standard_normal((1, 200, 128)).astype(np.float32)
    s = 64 ** -0.5
    a = at.fused_attention_merged(_t(q), _t(k), _t(v), 2, scale=s)
    b = at.fused_attention_merged(_t(q * s), _t(k), _t(v), 2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


def test_grad_matches_jax():
    """The Function's gradients (K5's plain version on split heads) against
    jax.grad of the JAX merged function, within 3e-4."""
    rng = np.random.default_rng(4)
    n_head, d = 2, 128
    q = (rng.standard_normal((1, 136, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((1, 150, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((1, 150, d)).astype(np.float32)

    def f_jax(q, k, v):
        return (jax_fused_attention_merged(q, k, v, n_head, interpret=True)
                ** 2).sum()

    want = jax.grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = at.fused_attention_merged(qt, kt, vt, n_head)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4)


def test_grad_matches_split_head_reference():
    """The same gradients against the JAX unfused attention on split heads
    (the reference's own oracle), with a scale inside."""
    rng = np.random.default_rng(6)
    n_head, d, s = 2, 64, 32 ** -0.5
    q, k, v, g = (rng.standard_normal((2, t, d)).astype(np.float32)
                  for t in (140, 131, 131, 140))

    def split(x):
        return x.reshape(2, -1, n_head, d // n_head).transpose(0, 2, 1, 3)

    def merge(x):
        return x.transpose(0, 2, 1, 3).reshape(2, -1, d)

    _, vjp = jax.vjp(lambda q, k, v: merge(_xla_attention(
        split(q), split(k), split(v), s)), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(
        at.fused_attention_merged(qt, kt, vt, n_head, scale=s), (qt, kt, vt),
        _t(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)


def test_layers_dispatch(monkeypatch):
    """use_merged_attention routes multi_head_attention through
    fused_attention_merged, with the output of the unfused core."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((1, 256, 128))) for _ in range(3))
    ref = layers.multi_head_attention(q, k, v, 2)

    calls = []

    def spy(q, k, v, n_head, scale=1.0):
        calls.append((tuple(q.shape), n_head, scale))
        return at.fused_attention_merged(q, k, v, n_head, scale)

    monkeypatch.setattr(layers, "fused_attention_merged", spy)
    monkeypatch.setattr(layers, "_fused_eligible", lambda q, mask: mask is None)
    layers.use_merged_attention(True)
    try:
        out = layers.multi_head_attention(q, k, v, 2)
    finally:
        layers.use_merged_attention(False)
    assert calls == [((1, 256, 128), 2, 64 ** -0.5)]
    assert float((out - ref).abs().max()) < 2e-5


def test_fused_eligible_policy():
    """Auto takes bf16 only; use_fused_attention(True) takes f32 too; a
    mask, a short query or the CPU never."""
    from types import SimpleNamespace

    def q(dtype, tq=128, device="cuda"):
        return SimpleNamespace(dtype=dtype, shape=(1, tq, 64),
                               device=torch.device(device))

    assert layers._fused_eligible(q(torch.bfloat16), None)
    assert not layers._fused_eligible(q(torch.float32), None)
    assert not layers._fused_eligible(q(torch.bfloat16, device="cpu"), None)
    try:
        layers.use_fused_attention(True)
        assert layers._fused_eligible(q(torch.float32), None)
        assert not layers._fused_eligible(q(torch.float32, tq=127), None)
        assert not layers._fused_eligible(q(torch.float32), torch.zeros(()))
        layers.use_fused_attention(False)
        assert not layers._fused_eligible(q(torch.bfloat16), None)
    finally:
        layers.use_fused_attention(None)


@pytest.mark.parametrize("value,want", [("1", "True"), ("0", "False"),
                                        (None, "False")])
def test_merged_env_read_at_import(value, want):
    env = {k: v for k, v in os.environ.items()
           if k != "WHISPER_IPA_TPU_MERGED_ATTN"}
    if value is not None:
        env["WHISPER_IPA_TPU_MERGED_ATTN"] = value
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run(
        [sys.executable, "-c",
         "import whisper_ipa_torch.models.layers as L; "
         "print(L._MERGED_ATTENTION)"],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == want


def test_merged_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        at.fused_attention_merged(torch.zeros((1, 4, 6)), torch.zeros((1, 4, 6)),
                                  torch.zeros((1, 4, 6)), 4)
    with pytest.raises(ValueError):
        at.fused_attention_merged(torch.zeros((1, 4, 8)), torch.zeros((1, 5, 8)),
                                  torch.zeros((1, 4, 8)), 2)
