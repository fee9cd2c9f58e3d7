"""PyTorch port: K9's plain version (stochastic int8 quantization) and
``quantize_params_device`` against the JAX package, on the CPU.

The two packages draw their uniforms from different generators (Philox
here, ``jax.random`` in the JAX package's CPU path), so codes are not
compared bit for bit; the contract is: each code the floor or the ceiling
of the quotient, the error below one step, and the quarter-step mean
unbiased within 0.02 (``tests/test_quant.py``). The scales are the IEEE
quotient max(amax, 1e-8) / 127, bit-identical to the host quantizer's (and
to the TPU kernel's division). XLA on the CPU rewrites that division by a
constant as a product with the f32 reciprocal, so the JAX package's CPU
scales are that product, at most one ulp away: the test states both. The
Philox generator itself is held to Random123's known answers. The CUDA
kernel equals the plain version bit for bit on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_ipa_tpu.ops.sr_quant as jax_sr
import whisper_ipa_torch.ops.sr_quant as sr
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import DecodingOptions, decode
from whisper_ipa_torch.models import flatten_params, params_from_numpy
from whisper_ipa_torch.ops.quant import quantize_params
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)


# Random123's known answers for Philox4x32-10: counter, key -> output
@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    c = [torch.tensor([x], dtype=torch.int64) for x in counter]
    got = sr.philox4x32_10(*c, *key)
    assert tuple(int(w) for w in got) == want


def _jax_cpu_scales(ours: np.ndarray, w: np.ndarray,
                    theirs: np.ndarray) -> None:
    """The JAX package's CPU scales are amax * f32(1/127), one ulp at most
    from the IEEE quotient that the port, the host quantizer and the
    kernels compute."""
    amax = np.maximum(np.abs(w).max(axis=0), np.float32(1e-8))
    np.testing.assert_array_equal(ours, amax / np.float32(127.0))
    np.testing.assert_array_equal(theirs, amax * np.float32(1.0 / 127.0))
    assert (np.abs(ours - theirs) <= np.spacing(ours)).all()


def _contract(w: np.ndarray, q: np.ndarray, s: np.ndarray) -> None:
    """Each code is floor or ceil of the IEEE quotient; error < one step."""
    quot = w / s  # float32 / float32: the IEEE quotient
    lo = np.clip(np.floor(quot), -127, 127)
    hi = np.clip(np.floor(quot) + 1, -127, 127)
    assert ((q == lo) | (q == hi)).all()
    deq = q.astype(np.float32) * s
    assert (np.abs(deq - w).max(axis=0) <= s + 1e-6).all()


@pytest.fixture(scope="module")
def weight():
    return np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32)


def test_plain_contract_against_jax(weight):
    q, s = sr.stochastic_quantize_int8(torch.from_numpy(weight), seed=3)
    assert q.dtype == torch.int8 and s.shape == (64,) and s.dtype == torch.float32
    jq, js = jax_sr.stochastic_quantize_int8(jnp.asarray(weight), seed=3)
    _jax_cpu_scales(s.numpy(), weight, np.asarray(js))
    _contract(weight, q.numpy(), s.numpy())
    _contract(weight, np.asarray(jq), np.asarray(js))
    # the same stochastic rounding: codes differ only where the draws do,
    # and then by one step
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1


def test_plain_scales_equal_host_quantizer(weight):
    from whisper_ipa_torch.ops.quant import quantize_linear

    _, s = sr.stochastic_quantize_int8(torch.from_numpy(weight), seed=1)
    host = quantize_linear({"w": torch.from_numpy(weight)})
    torch.testing.assert_close(s, host["w_s"], rtol=0, atol=0)
    # round-to-nearest and stochastic codes are at most one step apart
    q, _ = sr.stochastic_quantize_int8(torch.from_numpy(weight), seed=1)
    assert (q.int() - host["w_q"].int()).abs().max() <= 1


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_quarter_step_unbiased(package):
    w = np.full((4096, 8), 0.25, np.float32)
    w[0] = 127.0  # scale 1.0
    if package == "torch":
        q, s = (t.numpy() for t in sr.stochastic_quantize_int8(
            torch.from_numpy(w), seed=11))
    else:
        q, s = (np.asarray(t) for t in jax_sr.stochastic_quantize_int8(
            jnp.asarray(w), seed=11))
    assert (s == 1.0).all()
    deq = q[1:].astype(np.float32) * s
    assert abs(deq.mean() - 0.25) < 0.02


def test_seeds(weight):
    w = torch.from_numpy(weight)
    a, _ = sr.stochastic_quantize_int8(w, seed=5)
    b, _ = sr.stochastic_quantize_int8(w, seed=5)
    c, _ = sr.stochastic_quantize_int8(w, seed=6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_uniform_bits_are_uniform():
    u = sr.uniform_bits(512, 256, seed=0)
    assert u.dtype == torch.float32 and u.shape == (512, 256)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    # one row or one column of counters does not repeat another
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[:, 0], u[:, 1])


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        sr.stochastic_quantize_int8(torch.zeros(4))
    with pytest.raises(ValueError):
        sr.stochastic_quantize_int8(torch.zeros((0, 3)))


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    return params_from_numpy(flat)


def _recorded(monkeypatch, module, params, to_numpy):
    """quantize_params_device of ``module`` with each weight's seed
    recorded against the weight's values."""
    seen = []
    orig = module.stochastic_quantize_int8

    def record(w, seed=0):
        seen.append((seed, to_numpy(w)))
        return orig(w, seed=seed)

    monkeypatch.setattr(module, "stochastic_quantize_int8", record)
    out = module.quantize_params_device(params, seed=7)
    monkeypatch.undo()
    return out, seen


def test_quantize_params_device_matches_jax(monkeypatch, params, jax_params):
    qp, seen = _recorded(monkeypatch, sr, params, lambda w: w.numpy())
    jqp, jseen = _recorded(monkeypatch, jax_sr, jax_params, np.asarray)

    # every weight gets the same seed integer in both packages
    assert [s for s, _ in seen] == [s for s, _ in jseen] == list(
        range(8, 8 + len(seen)))
    for (_, a), (_, b) in zip(seen, jseen):
        np.testing.assert_array_equal(a, b)
    assert len(seen) == 6 * (JCFG.n_audio_layer + JCFG.n_text_layer) + (
        4 * JCFG.n_text_layer)

    flat = flatten_params(qp)
    jflat = {k: np.asarray(v) for k, v in jax_flatten_params(jqp).items()}
    host = flatten_params(quantize_params(params, bits=8))
    assert sorted(flat) == sorted(jflat) == sorted(host)
    for name, t in flat.items():
        assert tuple(t.shape) == jflat[name].shape == tuple(host[name].shape)
        assert str(t.dtype).split(".")[-1] == str(jflat[name].dtype), name
        if name.endswith(".w_s"):
            np.testing.assert_array_equal(t.numpy(), host[name].numpy())
            assert (np.abs(t.numpy() - jflat[name])
                    <= np.spacing(t.numpy())).all(), name
        elif name.endswith(".w_q"):
            assert (t.int() - host[name].int()).abs().max() <= 1
        else:  # biases, norms, embeddings, the conv stem: untouched
            np.testing.assert_array_equal(t.numpy(), jflat[name])


def test_quantize_params_device_decodes(params):
    qp = sr.quantize_params_device(params)
    blk = qp["decoder"]["blocks"][0]["attn"]["query"]
    assert "w_q" in blk and "w_s" in blk and "w" not in blk
    mel = np.random.default_rng(0).standard_normal(
        (1, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(np.float32)
    results = decode(
        qp, CFG, mel,
        DecodingOptions(language="en", without_timestamps=True, sample_len=4),
        tokenizer=get_tokenizer(multilingual=True, language="en"),
    )
    assert np.isfinite(results[0].avg_logprob)
