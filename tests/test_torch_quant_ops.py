"""PyTorch port: the quantization ops against the JAX package.

The host quantizers bit for bit; the plain versions of K3 (fused int8
cross-KV build), K6 (int8 x int8 product), K7 (int4-weight product) and K8
(int4 single-query decode attention) against the TPU kernels in interpret
mode and the reference's einsum paths; the quantized ``linear``; and the
new wrappers' CPU behaviour. The CUDA kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.models import layers as jax_layers
from whisper_ipa_tpu.models.whisper import _quantize_kv_heads4 as jax_quantize4
from whisper_ipa_tpu.ops import quant as jax_quant
from whisper_ipa_tpu.ops.decode_attention import (
    decode_cross_attention_int4_tminor as jax_decode_int4,
)
from whisper_ipa_tpu.ops.kv_init import fused_kv_init_int8 as jax_kv_init
from whisper_ipa_tpu.ops.quant_matmul import int4_matmul as jax_int4_matmul
from whisper_ipa_tpu.ops.quant_matmul import int8_matmul as jax_int8_matmul
from whisper_ipa_torch.models import layers
from whisper_ipa_torch.models.whisper import _quantize_kv_heads4
from whisper_ipa_torch.ops import (
    decode_attention_int4_plain,
    decode_cross_attention_int4_tminor,
    fused_kv_init_int8,
    fused_kv_init_plain,
    int4_matmul,
    int4_matmul_plain,
    int8_matmul,
    int8_matmul_plain,
)
from whisper_ipa_torch.ops import quant

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _weights(n_in=128, n_out=96, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_in, n_out)) * 0.1).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column: scale 1
    b = (rng.standard_normal(n_out) * 0.1).astype(np.float32)
    return w, b


# -- host quantizers ---------------------------------------------------------

@pytest.mark.parametrize("bits,stochastic", [(8, False), (4, False), (4, True)])
def test_quantize_linear_bit_identical(bits, stochastic):
    """Codes and scales equal the JAX package's bit for bit (a 96-row input
    dim also takes the int4 group fallback: gcd(96, 64) = 32)."""
    for n_in in (128, 96):
        w, b = _weights(n_in=n_in)
        kw = dict(group=64, stochastic=stochastic, seed=3)
        if bits == 8:
            ref = jax_quant.quantize_linear({"w": jnp.asarray(w), "b": b})
            ours = quant.quantize_linear({"w": _t(w), "b": _t(b)})
        else:
            ref = jax_quant.quantize_linear_int4({"w": jnp.asarray(w), "b": b}, **kw)
            ours = quant.quantize_linear_int4({"w": _t(w), "b": _t(b)}, **kw)
        assert sorted(ours) == sorted(ref)
        for k in ours:
            a, r = ours[k].numpy(), np.asarray(ref[k])
            assert a.dtype == r.dtype and a.shape == r.shape, k
            assert np.array_equal(a, r), k


def test_quantize_params_tree_and_bytes():
    """The whole tree: same leaves as the reference's quantize_params, and
    the same quantized_bytes, for bits 8 and 4, encoder included or not."""
    from dataclasses import replace

    from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
    from whisper_ipa_tpu.models import flatten_params as jax_flatten
    from whisper_ipa_tpu.models import init_params as jax_init
    from whisper_ipa_torch.models import params_from_numpy
    from whisper_ipa_torch.models.convert import flatten_params

    jp = jax_init(replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=16), seed=0)
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in jax_flatten(jp).items()})
    for bits, enc in ((8, True), (4, True), (4, False)):
        ref = {k: np.asarray(v) for k, v in jax_flatten(
            jax_quant.quantize_params(jp, bits=bits, quantize_encoder=enc)).items()}
        ours = flatten_params(quant.quantize_params(params, bits=bits,
                                                    quantize_encoder=enc))
        assert ours.keys() == ref.keys()
        for k, v in ref.items():
            assert ours[k].numpy().dtype == v.dtype and np.array_equal(
                ours[k].numpy(), v), k
        assert quant.quantized_bytes(quant.quantize_params(
            params, bits=bits, quantize_encoder=enc)) == jax_quant.quantized_bytes(
            jax_quant.quantize_params(jp, bits=bits, quantize_encoder=enc))
    with pytest.raises(ValueError):
        quant.quantize_params(params, bits=6)


@pytest.mark.parametrize("T", [150, 256])
def test_quantize_kv_heads4_bit_identical(T):
    rng = np.random.default_rng(T)
    x = (rng.standard_normal((2, T, 64)) * 0.5).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero position: scale floor 1e-8 / 7
    ref_p, ref_s = (np.asarray(a) for a in jax_quantize4(jnp.asarray(x), 2))
    p, s = _quantize_kv_heads4(torch.from_numpy(x), 2)
    assert p.dtype == torch.int8 and s.dtype == torch.float32
    assert p.shape == ref_p.shape == (2, 2, 32, 128)
    assert s.shape == ref_s.shape == (2, 2, 256)
    assert np.array_equal(p.numpy(), ref_p)
    assert np.array_equal(s.numpy(), ref_s)


# -- quantized linear ----------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_linear_matches_jax(bits, dtype):
    """f32: relative 1e-6 of max|y| (summation order); bf16: both round
    the half-weights and the two partial products to bf16, at other places
    inside the products, so 1e-2."""
    w, b = _weights(n_in=128, n_out=96)
    x = np.random.default_rng(1).standard_normal((3, 5, 128)).astype(np.float32)
    qj = (jax_quant.quantize_linear if bits == 8
          else jax_quant.quantize_linear_int4)({"w": jnp.asarray(w), "b": b})
    qt = {k: _t(v) for k, v in qj.items()}
    ref = jax_layers.linear(jnp.asarray(x).astype(dtype), qj)
    ours = layers.linear(_t(x).to(getattr(torch, dtype)), qt)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (3, 5, 96)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert _rel(_np(ours), np.asarray(ref, np.float32)) < tol


def test_unpack_int4_matches_jax():
    w, _ = _weights()
    qj = jax_quant.quantize_linear_int4({"w": jnp.asarray(w)})
    ref = np.asarray(jax_layers._unpack_int4(qj["w_q4"], qj["w_s4"], jnp.float32))
    ours = layers._unpack_int4(_t(qj["w_q4"]), _t(qj["w_s4"]), torch.float32)
    assert np.array_equal(ours.numpy(), ref)
    assert np.max(np.abs(ref - w)) <= np.max(np.abs(w)) / 7.0  # half a step


def test_int8_activations_ignored_on_cpu():
    """The switch selects K6 only on CUDA; the CPU keeps the weight-only
    path, as the reference's CPU does."""
    w, b = _weights()
    q = {k: v for k, v in quant.quantize_linear({"w": _t(w), "b": _t(b)}).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 128))
                         .astype(np.float32))
    want = layers.linear(x, q)
    try:
        layers.use_int8_activations(True)
        got = layers.linear(x, q)
    finally:
        layers.use_int8_activations(False)
    assert torch.equal(got, want)
    assert int8_matmul.launches == 0


# -- K6: int8 x int8 ----------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(5, 64, 96), (130, 256, 64)])
def test_int8_matmul_plain_matches_pallas(m, k, n):
    """Relative 1e-6 of max|y|: the same integer sums, rescaled in f32."""
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, k)) * 0.7).astype(np.float32)
    x[1] = 0.0  # an all-zero row: scale floor 1e-6 / 127
    q = jax_quant.quantize_linear({"w": jnp.asarray(
        (rng.standard_normal((k, n)) * 0.1).astype(np.float32))})
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), q["w_q"], q["w_s"],
                                     interpret=True))
    ours = int8_matmul_plain(_t(x), _t(q["w_q"]), _t(q["w_s"]))
    assert ours.dtype == torch.float32 and ours.shape == (m, n)
    assert _rel(ours.numpy(), ref) <= 1e-6


def test_int8_matmul_plain_sums_exactly():
    """At K = 3072 (mlp2) a sum of int8 products passes 2^24; the plain
    version's sum must be exact: against an int64 reference."""
    k = 3072
    x = torch.full((2, k), 1.0)
    x[1, ::2] = -1.0
    w_q = torch.full((k, 3), 127, dtype=torch.int8)
    w_q[::3, 1] = -127
    out = int8_matmul_plain(x, w_q, torch.ones(3))
    xq = torch.round(x / (1.0 / 127)).clamp(-127, 127).long()
    exact = (xq @ w_q.long()).float() * (1.0 / 127)
    assert torch.equal(out, exact)


# -- K7: int4 weights --------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(3, 128, 96), (40, 256, 300)])
def test_int4_matmul_plain_matches_pallas(m, k, n):
    """Relative 1e-5 of max|y|: f32 products summed in another order."""
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((m, k))).astype(np.float32)
    q = jax_quant.quantize_linear_int4({"w": jnp.asarray(
        (rng.standard_normal((k, n)) * 0.1).astype(np.float32))})
    ref = np.asarray(jax_int4_matmul(jnp.asarray(x), q["w_q4"], q["w_s4"],
                                     interpret=True))
    ours = int4_matmul_plain(_t(x).reshape(1, m, k), _t(q["w_q4"]), _t(q["w_s4"]))
    assert ours.dtype == torch.float32 and ours.shape == (1, m, n)
    assert _rel(ours[0].numpy(), ref) <= 1e-5


# -- K8: int4 decode attention ----------------------------------------------------

def _int4_cache(B=2, H=3, dh=64, T=400, seed=0):
    """Quantized K/V of random features, T padded to 128 (scale 0 past T)."""
    rng = np.random.default_rng(seed)
    kf = rng.standard_normal((B, T, H * dh)).astype(np.float32)
    vf = rng.standard_normal((B, T, H * dh)).astype(np.float32)
    kq, ks = jax_quantize4(jnp.asarray(kf), H)
    vq, vs = jax_quantize4(jnp.asarray(vf), H)
    q = (rng.standard_normal((B, H, 1, dh)) * dh ** -0.5).astype(np.float32)
    return [np.array(a) for a in (q, kq, ks, vq, vs)]


@pytest.mark.parametrize("dh", [32, 64])
def test_decode_attention_int4_plain_matches_pallas(dh):
    """f32, rtol = atol = 1e-5, against the TPU kernel in interpret mode
    (T_pad 512: its packed axis must be a multiple of 128) and the
    reference's plane path (``_mha_int4kv``)."""
    arrays = _int4_cache(dh=dh)
    assert arrays[1].shape[-1] == 256 and np.all(arrays[2][..., 400:] == 0)
    ref = np.asarray(jax_decode_int4(*[jnp.asarray(a) for a in arrays],
                                     interpret=True))
    planes = np.asarray(jax_layers._mha_int4kv(*[jnp.asarray(a) for a in arrays]))
    ours = decode_attention_int4_plain(*[torch.from_numpy(a) for a in arrays])
    assert ours.shape == ref.shape == (2, 3, 1, dh)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.merge_heads(ours).numpy(), planes, rtol=1e-5, atol=1e-5)


def test_decode_attention_int4_prefix_matches_planes():
    """Several queries (the SOT prefix) at test-tiny's T_pad 128, whose
    packed axis (64) the TPU kernel does not take: the plane path."""
    B, H, dh, S = 2, 2, 32, 3
    rng = np.random.default_rng(5)
    kq, ks = jax_quantize4(jnp.asarray(rng.standard_normal((B, 32, H * dh))
                                       .astype(np.float32)), H)
    vq, vs = jax_quantize4(jnp.asarray(rng.standard_normal((B, 32, H * dh))
                                       .astype(np.float32)), H)
    q = (rng.standard_normal((B, H, S, dh)) * dh ** -0.5).astype(np.float32)
    arrays = [np.array(a) for a in (q, kq, ks, vq, vs)]
    ref = np.asarray(jax_layers._mha_int4kv(*[jnp.asarray(a) for a in arrays]))
    ours = layers.merge_heads(
        decode_attention_int4_plain(*[torch.from_numpy(a) for a in arrays]))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_decode_attention_int4_ignores_padded_positions():
    q, kq, ks, vq, vs = _int4_cache(dh=32, T=300)
    kq2, vq2 = kq.copy(), vq.copy()
    kq2[..., 150:] = 0x77  # positions 300.. (two a byte) hold code 7
    vq2[..., 150:] = -0x77
    a = decode_attention_int4_plain(*[torch.from_numpy(x) for x in (q, kq, ks, vq, vs)])
    b = decode_attention_int4_plain(
        *[torch.from_numpy(x) for x in (q, kq2, ks, vq2, vs)])
    assert torch.equal(a, b)


# -- K3: fused int8 cross-KV build ---------------------------------------------

def _kv_inputs(B=2, T=150, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, d)) * 0.5).astype(np.float32)
    wk = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
    wv = (rng.standard_normal((d, d)) * 0.1).astype(np.float32)
    bv = (rng.standard_normal((d,)) * 0.1).astype(np.float32)
    return x, wk, wv, bv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_init_plain_matches_pallas(dtype):
    """tests/test_kv_init.py's bounds: scales rtol 1e-6, codes within 1 and
    more than 99.9% equal (a rounding tie may fall either way)."""
    H = 2
    x, wk, wv, bv = _kv_inputs()
    ref = jax_kv_init(jnp.asarray(x), jnp.asarray(wk), None, jnp.asarray(wv),
                      jnp.asarray(bv), H, out_dtype=getattr(jnp, dtype),
                      interpret=True)
    ours = fused_kv_init_plain(_t(x), _t(wk), None, _t(wv), _t(bv), H,
                               getattr(torch, dtype))
    for got, want in zip(ours, ref):
        want = np.asarray(want)
        assert got.shape == want.shape and got.numpy().dtype == want.dtype
    for i in (1, 3):
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-6, atol=1e-9)
    for i in (0, 2):
        diff = np.abs(ours[i].numpy().astype(np.int32)
                      - np.asarray(ref[i]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def test_kv_init_padding_contract():
    """Positions >= T carry scale 0 and code 0; T_pad is the 128 round-up;
    and the result equals linear() followed by the int8 quantizer."""
    from whisper_ipa_torch.models.whisper import _quantize_kv_heads

    x, wk, wv, bv = (_t(a) for a in _kv_inputs(T=150))
    kq, ks, vq, vs = fused_kv_init_plain(x, wk, None, wv, bv, 2, torch.float32)
    assert kq.shape == (2, 2, 32, 256) and ks.shape == (2, 2, 256)
    for s in (ks, vs):
        assert (s[..., 150:] == 0).all() and (s[..., :150] > 0).all()
    for c in (kq, vq):
        assert (c[..., 150:] == 0).all()
    ref = _quantize_kv_heads(layers.linear(x, {"w": wv, "b": bv}), 2)
    assert torch.equal(vq, ref[0]) and torch.equal(vs, ref[1])


# -- the wrappers on CPU tensors ---------------------------------------------------

def test_new_wrappers_use_plain_versions_on_cpu():
    """A CPU tensor takes the plain version and never counts a launch."""
    counters = (fused_kv_init_int8, int8_matmul, int4_matmul,
                decode_cross_attention_int4_tminor)
    before = [fn.launches for fn in counters]
    x, wk, wv, bv = (_t(a) for a in _kv_inputs())
    for a, b in zip(fused_kv_init_int8(x, wk, None, wv, bv, 2, torch.float32),
                    fused_kv_init_plain(x, wk, None, wv, bv, 2, torch.float32)):
        assert torch.equal(a, b)
    w, _ = _weights()
    q8 = quant.quantize_linear({"w": _t(w)})
    q4 = quant.quantize_linear_int4({"w": _t(w)})
    xm = torch.randn(4, 128)
    assert torch.equal(int8_matmul(xm, q8["w_q"], q8["w_s"]),
                       int8_matmul_plain(xm, q8["w_q"], q8["w_s"]))
    assert torch.equal(int4_matmul(xm, q4["w_q4"], q4["w_s4"]),
                       int4_matmul_plain(xm, q4["w_q4"], q4["w_s4"]))
    arrays = [torch.from_numpy(a) for a in _int4_cache(dh=32)]
    assert torch.equal(decode_cross_attention_int4_tminor(*arrays),
                       decode_attention_int4_plain(*arrays))
    assert [fn.launches for fn in counters] == before == [0, 0, 0, 0]


def test_new_wrappers_check_their_inputs():
    w, _ = _weights()
    q8 = quant.quantize_linear({"w": _t(w)})
    q4 = quant.quantize_linear_int4({"w": _t(w)})
    with pytest.raises(ValueError):  # K mismatch
        int8_matmul(torch.randn(2, 64), q8["w_q"], q8["w_s"])
    with pytest.raises(ValueError):  # float weights
        int8_matmul(torch.randn(2, 128), q8["w_q"].float(), q8["w_s"])
    with pytest.raises(ValueError):  # packed rows != K / 2
        int4_matmul(torch.randn(2, 64), q4["w_q4"], q4["w_s4"])
    with pytest.raises(ValueError):  # groups not dividing K / 2
        int4_matmul(torch.randn(2, 128), q4["w_q4"], q4["w_s4"][:1].repeat(3, 1))
    arrays = [torch.from_numpy(a) for a in _int4_cache(dh=32)]
    with pytest.raises(ValueError):  # unpacked (int8-shaped) codes
        decode_cross_attention_int4_tminor(
            arrays[0], arrays[1].repeat(1, 1, 1, 2), arrays[2],
            arrays[3].repeat(1, 1, 1, 2), arrays[4])
    with pytest.raises(ValueError):  # two queries
        decode_cross_attention_int4_tminor(torch.cat([arrays[0]] * 2, dim=2),
                                           *arrays[1:])
    x, wk, wv, bv = (_t(a) for a in _kv_inputs())
    with pytest.raises(ValueError):
        fused_kv_init_int8(x, wk, None, wv[:, :32], bv, 2)
    with pytest.raises(ValueError):
        fused_kv_init_int8(x, wk, None, wv, bv, 2, out_dtype=torch.float16)
