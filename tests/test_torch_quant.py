"""PyTorch port: quantized serving against the JAX package, on the CPU.

Same weights (numpy bridge), each package quantizing them with its own
``quantize_params``; same mel; same options. In f32 the port's greedy
tokens must equal ``whisper_ipa_tpu.decode.decode`` for int8 and int4
weights, the int4 cross cache, and the int8 cross cache built by the fused
path (K3's plain version here, the Pallas kernel in interpret mode there).
The service with quantized weights and the int4 cache gives the texts of
``decode()``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.decode import DecodingOptions as JaxOptions
from whisper_ipa_tpu.decode import decode as jax_decode
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models import whisper as jax_whisper
from whisper_ipa_tpu.ops.quant import quantize_params as jax_quantize_params
from whisper_ipa_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_ipa_torch.audio import N_SAMPLES, SAMPLE_RATE
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import DecodingOptions, decode
from whisper_ipa_torch.models import (
    init_cache,
    init_params,
    params_from_numpy,
    use_fused_kv_init,
)
from whisper_ipa_torch.models import whisper as torch_whisper
from whisper_ipa_torch.ops import log_mel_spectrogram
from whisper_ipa_torch.ops.quant import quantize_params
from whisper_ipa_torch.serve import TranscriptionService
from whisper_ipa_torch.tokenizer import get_tokenizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
SAMPLE_LEN = 16


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def params(jax_params):
    flat = {k: np.asarray(v) for k, v in jax_flatten_params(jax_params).items()}
    return params_from_numpy(flat)


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return rng.standard_normal((4, 2 * CFG.n_audio_ctx, CFG.n_mels)).astype(
        np.float32)


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def jtok():
    return jax_get_tokenizer(multilingual=True, language="en")


@pytest.fixture
def fused_kv_init():
    """Both packages' fused cross-KV switch on for one test."""
    jax_whisper.use_fused_kv_init(True)
    use_fused_kv_init(True)
    yield
    jax_whisper.use_fused_kv_init(False)
    use_fused_kv_init(False)


def _options(cls, **kw):
    return cls(language="en", without_timestamps=True, sample_len=SAMPLE_LEN, **kw)


def _features(seed=1, B=2):
    x = np.random.default_rng(seed).standard_normal(
        (B, CFG.n_audio_ctx, CFG.n_text_state)).astype(np.float32)
    return 0.3 * x


# -- init_cache ----------------------------------------------------------------

def _codes(packed: np.ndarray, int4: bool) -> np.ndarray:
    """The int8 codes, or both nibbles of the int4 bytes, as int32."""
    c = packed.astype(np.int32)
    return np.stack([(c << 28) >> 28, c >> 4]) if int4 else c


def _assert_cache_close(ours, ref, int4: bool):
    """Scales rtol 1e-6; codes within 1 and more than 99.9% equal: the
    projections are summed in another order than XLA's."""
    for a, b in ((ours.cross_k_scale, ref.cross_k_scale),
                 (ours.cross_v_scale, ref.cross_v_scale)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
    for a, b in ((ours.cross_k, ref.cross_k), (ours.cross_v, ref.cross_v)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.int8
        diff = np.abs(_codes(a.numpy(), int4) - _codes(b, int4))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def _count_fused_calls(monkeypatch):
    calls = []
    real = torch_whisper.fused_kv_init_int8
    monkeypatch.setattr(torch_whisper, "fused_kv_init_int8",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_init_cache_fused_matches_jax(params, jax_params, fused_kv_init,
                                      monkeypatch):
    feats = _features()
    calls = _count_fused_calls(monkeypatch)
    ours = init_cache(params, CFG, torch.from_numpy(feats), max_len=8,
                      cross_kv_int8=True)
    ref = jax_whisper.init_cache(jax_params, JCFG, jnp.asarray(feats), max_len=8,
                                 cross_kv_int8=True)
    assert len(calls) == CFG.n_text_layer
    assert ours.cross_k.shape == (CFG.n_text_layer, 2, 2, 32, 128)
    _assert_cache_close(ours, ref, int4=False)


@pytest.mark.parametrize("bits", [None, 4])
def test_init_cache_int4_matches_jax(params, jax_params, bits):
    """The int4 cross cache, from float and from int4 weights (the fused
    switch stays off for quantized weights, as in the reference)."""
    jp = jax_params if bits is None else jax_quantize_params(jax_params, bits=bits)
    tp = params if bits is None else quantize_params(params, bits=bits)
    feats = _features(seed=2)
    ours = init_cache(tp, CFG, torch.from_numpy(feats), max_len=8,
                      cross_kv_int4=True)
    ref = jax_whisper.init_cache(jp, JCFG, jnp.asarray(feats), max_len=8,
                                 cross_kv_int4=True)
    assert ours.cross_k.shape == (CFG.n_text_layer, 2, 2, 32, 64)
    assert ours.cross_k_scale.shape == (CFG.n_text_layer, 2, 2, 128)
    _assert_cache_close(ours, ref, int4=True)


def test_fused_switch_skips_quantized_weights_and_int4(params, fused_kv_init,
                                                      monkeypatch):
    """The reference's condition: float cross weights and the int8 cache."""
    calls = _count_fused_calls(monkeypatch)
    feats = torch.from_numpy(_features())
    init_cache(quantize_params(params, bits=8), CFG, feats, max_len=8,
               cross_kv_int8=True)
    init_cache(params, CFG, feats, max_len=8, cross_kv_int8=True,
               cross_kv_int4=True)
    assert calls == []
    init_cache(params, CFG, feats, max_len=8, cross_kv_int8=True)
    assert len(calls) == CFG.n_text_layer


@pytest.mark.parametrize("switch", [False, True])
def test_init_cache_bf16_on_the_cpu_keeps_its_route(params, jax_params, switch,
                                                    monkeypatch):
    """K3's bf16 body takes only CUDA tensors: on the CPU in bf16 the int8
    cache is built by ``linear`` + the quantizer with the fused switch off
    (no call of ``fused_kv_init_int8``) and by K3's plain version with it
    on (one call a layer), and either build matches the JAX package's bf16
    build. Bounds as ``tests/test_torch_cuda.py::test_kv_init_kernel``
    holds a bf16 build with a bias: scales within 2^-6 relative (the two
    packages sum the projection in another order, so a bf16 rounding may
    fall the other way), codes >= 99.9% equal and within 1 where the
    (position, head) scale is the same, 2 where it is not."""
    feats = _features(seed=3)
    calls = _count_fused_calls(monkeypatch)
    use_fused_kv_init(switch)
    try:
        ours = init_cache(params, CFG, torch.from_numpy(feats), max_len=8,
                          dtype=torch.bfloat16, cross_kv_int8=True)
    finally:
        use_fused_kv_init(False)
    ref = jax_whisper.init_cache(jax_params, JCFG, jnp.asarray(feats), max_len=8,
                                 dtype=jnp.bfloat16, cross_kv_int8=True)
    assert len(calls) == (CFG.n_text_layer if switch else 0)
    assert ours.self_k.dtype == torch.bfloat16
    for codes, scale, rcodes, rscale in (
            (ours.cross_k, ours.cross_k_scale, ref.cross_k, ref.cross_k_scale),
            (ours.cross_v, ours.cross_v_scale, ref.cross_v, ref.cross_v_scale)):
        rscale = torch.from_numpy(np.array(rscale))
        rcodes = torch.from_numpy(np.array(rcodes))
        assert codes.shape == rcodes.shape == (CFG.n_text_layer, 2, 2, 32, 128)
        assert ((scale - rscale).abs() <= 2 ** -6 * rscale.abs()).all()
        diff = (codes.int() - rcodes.int()).abs()
        same = (scale == rscale)[..., None, :]
        assert (diff <= torch.where(same, 1, 2)).all()
        assert (diff == 0).float().mean().item() >= 0.999


# -- greedy decoding ---------------------------------------------------------------

@pytest.mark.parametrize(
    "bits,kv",
    [
        (8, dict(kv_int8=True)),
        (4, dict()),
        (None, dict(kv_int4=True)),
        (4, dict(kv_int4=True)),
    ],
)
def test_greedy_tokens_match_jax_f32(params, jax_params, mel, tok, jtok, bits, kv):
    jp = jax_params if bits is None else jax_quantize_params(jax_params, bits=bits)
    tp = params if bits is None else quantize_params(params, bits=bits)
    ref = jax_decode(jp, JCFG, jnp.asarray(mel), _options(JaxOptions, **kv),
                     tokenizer=jtok)
    ours = decode(tp, CFG, mel, _options(DecodingOptions, **kv), tokenizer=tok)
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        assert a.tokens == b.tokens
        assert a.text == b.text
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=1e-6)


def test_greedy_tokens_fused_kv_init_match_jax(params, jax_params, mel, tok, jtok,
                                               fused_kv_init):
    """int8 cross cache built by the fused path in both packages (3 rows:
    a shape no other test in this file traces, so JAX traces anew with the
    switch on)."""
    ref = jax_decode(jax_params, JCFG, jnp.asarray(mel[:3]),
                     _options(JaxOptions, kv_int8=True), tokenizer=jtok)
    ours = decode(params, CFG, mel[:3], _options(DecodingOptions, kv_int8=True),
                  tokenizer=tok)
    for a, b in zip(ours, ref):
        assert a.tokens == b.tokens
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)


# -- the service ----------------------------------------------------------------

# full 30 s windows need n_audio_ctx 1500; test-tiny's two thin layers keep
# the CPU encoder cheap
SERVE_CFG = replace(CONFIGS["test-tiny"], n_text_ctx=48)


@pytest.mark.parametrize("kw", [dict(quant_bits=8), dict(quant_bits=4, kv_int4=True)])
def test_service_quantized_matches_decode(kw):
    params = init_params(SERVE_CFG, seed=0)
    tok = get_tokenizer(multilingual=True, language="en")
    svc = TranscriptionService(params, SERVE_CFG, device="cpu", batch_size=1,
                               max_wait_ms=10.0, bf16=False, tokenizer=tok, **kw)
    try:
        audio = (np.random.default_rng(3).standard_normal(5 * SAMPLE_RATE)
                 * 0.1).astype(np.float32)
        out = svc.submit(audio).result(timeout=300)
    finally:
        svc.close()
    assert not svc._thread.is_alive()
    assert svc.options.kv_int4 == kw.get("kv_int4", False)
    assert svc.options.kv_int8 == (not kw.get("kv_int4", False))
    leaf = svc.params["decoder"]["blocks"][0]["mlp1"]
    assert ("w_q4" if kw["quant_bits"] == 4 else "w_q") in leaf
    window = np.zeros(N_SAMPLES, np.float32)
    window[: len(audio)] = audio
    mels = log_mel_spectrogram(torch.from_numpy(window[None]), SERVE_CFG.n_mels)
    ref = decode(quantize_params(params, bits=kw["quant_bits"]), SERVE_CFG, mels,
                 svc.options, tokenizer=tok)
    assert out["segments"][0]["text"] == ref[0].text
    assert out["segments"][0]["avg_logprob"] == pytest.approx(ref[0].avg_logprob,
                                                              abs=1e-6)
