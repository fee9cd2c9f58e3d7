"""PyTorch port: the reference's public surface, the repaired faults and the
host modules, on the CPU.

- Every public name of ``whisper_ipa_tpu.{models,train,decode,metrics,
  utils}`` imports from the port's package of the same name, except the
  names recorded as not ported (each skipped with its ROADMAP item).
- ``ops.sr_quant.quantize_linear_device`` maps {"w"} to {"w_q", "w_s"}
  through the stochastic quantizer, as the JAX package's does; codes and
  scales are held to the JAX package's with the caveats of
  ``tests/test_torch_sr_quant.py`` (another random generator, and XLA's
  CPU scales one ulp off the IEEE quotient).
- ``cli.serve`` parses ``--no-aot-cache`` and builds the server with it;
  under ``--continuous`` the five engine flags reach the engine.
- ``utils.tree_count``/``tree_bytes``/``tree_summary`` of the port's trees
  equal the JAX package's on the same weights.
- ``metrics.analysis`` (alignment, confusion report) equals the JAX
  package's on pairs with substitutions, insertions, deletions and empty
  strings.
- The native edit-distance and WAV cores (``native/libwipa_native.so``)
  and the NumPy/Python paths agree with each other and with the JAX
  package's; skipped where the library is not built.
"""

import importlib
import io
import os
from contextlib import redirect_stdout
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_LIB = os.path.join(REPO_ROOT, "native", "libwipa_native.so")

torch.set_num_threads(1)

# the reference's names the port does not have, with the reason
NOT_PORTED = {
    "train": {
        "clip_by_per_tensor_norm": "an optax GradientTransformation; the port "
                                   "has no optax: train.optimizer.Optimizer "
                                   "clips per tensor (ROADMAP item [14])",
        "decoder_only_mask": "an optax mask tree; Optimizer takes "
                             "freeze_encoder (ROADMAP item [14])",
        "make_optimizer": "builds an optax chain; Optimizer is the port's "
                          "(ROADMAP item [14])",
    },
}
SURFACE = [
    (pkg, name)
    for pkg in ("models", "train", "decode", "metrics", "utils", "data.prep",
                "parallel")
    for name in importlib.import_module(f"whisper_ipa_tpu.{pkg}").__all__
]


@pytest.mark.parametrize("pkg,name", SURFACE,
                         ids=[f"{p}.{n}" for p, n in SURFACE])
def test_reference_surface(pkg, name):
    port = importlib.import_module(f"whisper_ipa_torch.{pkg}")
    reason = NOT_PORTED.get(pkg, {}).get(name)
    if reason:
        assert not hasattr(port, name), f"{pkg}.{name} is ported: unlist it"
        pytest.skip(f"not ported: {reason}")
    assert name in port.__all__, f"{pkg}.{name} missing from __all__"
    ours = getattr(port, name)
    theirs = getattr(importlib.import_module(f"whisper_ipa_tpu.{pkg}"), name)
    assert callable(ours) == callable(theirs)
    assert isinstance(ours, type) == isinstance(theirs, type)


# utils' submodules: their public names, defined in the module itself
UTILS_NOT_PORTED = {
    "TPU_PEAK_FLOPS": "TPU rates; the port keys its peaks by CUDA device "
                      "name in GPU_PEAK_FLOPS (ROADMAP item [14])",
}
UTILS_SURFACE = [
    (mod, name)
    for mod in ("flops", "xlsx")
    for name, value in sorted(vars(importlib.import_module(
        f"whisper_ipa_tpu.utils.{mod}")).items())
    if not name.startswith("_")
    and getattr(value, "__module__", None) == f"whisper_ipa_tpu.utils.{mod}"
    or name.isupper() and not name.startswith("_")
]


@pytest.mark.parametrize("mod,name", UTILS_SURFACE,
                         ids=[f"utils.{m}.{n}" for m, n in UTILS_SURFACE])
def test_utils_submodule_surface(mod, name):
    port = importlib.import_module(f"whisper_ipa_torch.utils.{mod}")
    reason = UTILS_NOT_PORTED.get(name)
    if reason:
        assert not hasattr(port, name), f"utils.{mod}.{name} is ported"
        pytest.skip(f"not ported: {reason}")
    ours = getattr(port, name)
    theirs = getattr(importlib.import_module(
        f"whisper_ipa_tpu.utils.{mod}"), name)
    assert callable(ours) == callable(theirs)
    if callable(ours):
        import inspect

        assert (list(inspect.signature(ours).parameters)
                == list(inspect.signature(theirs).parameters))


def test_embed_audio_is_encode():
    from whisper_ipa_torch import models
    from whisper_ipa_torch.models import whisper

    assert models.embed_audio is models.encode is whisper.embed_audio


def test_logits_is_decoder_logits():
    """The reference-surface alias of the JAX package's models/whisper.py."""
    from whisper_ipa_tpu.models import whisper as jax_whisper
    from whisper_ipa_torch.models import whisper

    assert jax_whisper.logits is jax_whisper.decoder_logits
    assert whisper.logits is whisper.decoder_logits


def test_count_parameters_and_mlx_names_match_jax():
    from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
    from whisper_ipa_tpu.models import count_parameters as jax_count
    from whisper_ipa_tpu.models import init_params as jax_init
    from whisper_ipa_tpu.models import to_mlx_flat as jax_to_mlx
    from whisper_ipa_torch.config import CONFIGS
    from whisper_ipa_torch.models import count_parameters, init_params, to_mlx_flat

    cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
    jcfg = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
    params, jparams = init_params(cfg, seed=0), jax_init(jcfg, seed=0)
    assert count_parameters(params) == jax_count(jparams)
    ours, theirs = to_mlx_flat(params), jax_to_mlx(jparams)
    assert sorted(ours) == sorted(theirs)
    assert all(tuple(ours[k].shape) == tuple(theirs[k].shape) for k in ours)


# -- quantize_linear_device ------------------------------------------------

def test_quantize_linear_device_matches_jax():
    import whisper_ipa_tpu.ops.sr_quant as jax_sr
    import whisper_ipa_torch.ops.sr_quant as sr

    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ours = sr.quantize_linear_device(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, seed=3)
    theirs = jax_sr.quantize_linear_device(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, seed=3)
    assert sorted(ours) == sorted(theirs) == ["b", "w_q", "w_s"]
    np.testing.assert_array_equal(ours["b"].numpy(), b)
    # the wrapper is the stochastic quantizer with that seed
    q, s = sr.stochastic_quantize_int8(torch.from_numpy(w), seed=3)
    assert torch.equal(ours["w_q"], q) and torch.equal(ours["w_s"], s)
    # scales: the IEEE quotient here, XLA's CPU reciprocal product there
    amax = np.maximum(np.abs(w).max(axis=0), np.float32(1e-8))
    np.testing.assert_array_equal(ours["w_s"].numpy(), amax / np.float32(127.0))
    np.testing.assert_array_equal(np.asarray(theirs["w_s"]),
                                  amax * np.float32(1.0 / 127.0))
    # codes: floor or ceiling of the quotient in both, one step apart at most
    jq = np.asarray(theirs["w_q"])
    for codes, scales in ((ours["w_q"].numpy(), ours["w_s"].numpy()),
                          (jq, np.asarray(theirs["w_s"]))):
        lo = np.clip(np.floor(w / scales), -127, 127)
        assert ((codes == lo) | (codes == np.clip(lo + 1, -127, 127))).all()
    assert np.abs(ours["w_q"].numpy().astype(int) - jq.astype(int)).max() <= 1


# -- cli.serve --no-aot-cache ----------------------------------------------

def test_serve_parses_no_aot_cache():
    from whisper_ipa_tpu.cli import serve as jax_serve
    from whisper_ipa_torch.cli import serve as serve_cli

    args = serve_cli.build_parser().parse_args(["--no-aot-cache"])
    assert args.aot_cache is False
    assert serve_cli.build_parser().parse_args([]).aot_cache is True
    help_text = " ".join(serve_cli.build_parser().format_help().split())
    assert "no executable cache" in help_text
    # the reference's parser stores the same destination
    jax_help = io.StringIO()
    with redirect_stdout(jax_help), pytest.raises(SystemExit):
        jax_serve.main(["--help"])
    assert "--no-aot-cache" in jax_help.getvalue()
    server, service = serve_cli.build_server(
        ["--model", "test-tiny", "--port", "0", "--device", "cpu",
         "--no-aot-cache"])
    try:
        assert server.server_address[1] > 0
    finally:
        server.server_close()
        service.close()


def test_serve_continuous_takes_the_engine_flags():
    """Under --continuous the reference's five engine flags reach the
    engine, with --batch-size as its slots, bf16 and the int8 cross cache."""
    from whisper_ipa_torch.cli import serve as serve_cli
    from whisper_ipa_torch.serve_continuous import ContinuousBatcher

    server, service = serve_cli.build_server(
        ["--model", "test-tiny", "--port", "0", "--device", "cpu",
         "--continuous", "--batch-size", "3", "--max-new-tokens", "16",
         "--steps-per-sync", "8", "--adaptive-sync", "--no-join-fast-sync",
         "--max-pending", "5"])
    try:
        assert isinstance(service, ContinuousBatcher)
        got = (service.slots, service.max_new, service.steps_per_sync,
               service.adaptive_sync, service.join_fast_sync,
               service.max_pending, service.dtype, service.kv_int8)
        assert got == (3, 16, 8, True, False, 5, torch.bfloat16, True)
    finally:
        server.server_close()
        service.close()
    assert not service._thread.is_alive()


# -- utils.trees -----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    """(port params, JAX params) holding the same test-tiny weights."""
    from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
    from whisper_ipa_tpu.models import init_params as jax_init
    from whisper_ipa_tpu.models import flatten_params as jax_flatten
    from whisper_ipa_torch.models import params_from_numpy

    jparams = jax_init(replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32,
                               n_text_ctx=48), seed=0)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jparams).items()}
    return params_from_numpy(flat), jparams


@pytest.mark.parametrize("tree", ["float32", "int8", "int4"])
def test_trees_match_jax(tiny_pair, tree):
    from whisper_ipa_tpu.ops.quant import quantize_params as jax_quantize
    from whisper_ipa_tpu.utils import trees as jax_trees
    from whisper_ipa_torch.ops.quant import quantize_params
    from whisper_ipa_torch.utils import tree_bytes, tree_count, tree_summary

    params, jparams = tiny_pair
    if tree != "float32":
        bits = int(tree[3:])
        params, jparams = (quantize_params(params, bits=bits),
                           jax_quantize(jparams, bits=bits))
    assert tree_count(params) == jax_trees.tree_count(jparams)
    assert tree_bytes(params) == jax_trees.tree_bytes(jparams)
    for depth in (1, 2, 3):
        assert tree_summary(params, depth) == jax_trees.tree_summary(
            jparams, depth)


def test_step_timer_and_throughput():
    from whisper_ipa_torch.utils import StepTimer, Throughput

    timer = StepTimer()
    with timer:
        pass
    timer.start()
    assert timer.stop(sync={"x": torch.ones(2)}) >= 0.0
    assert len(timer.samples) == 2 and timer.mean >= 0.0
    assert timer.percentile(50) in timer.samples
    assert StepTimer().percentile(90) == 0.0
    meter = Throughput(window=3)
    assert meter.rate == 0.0
    for n in (4, 4, 4, 4):
        meter.update(n)
    assert len(meter._events) == 3 and meter.rate > 0.0


# -- metrics.analysis ------------------------------------------------------

PAIRS = [
    ("kæt", "kæt"),  # match
    ("kæt", "kɛt"),  # substitution
    ("ʃip", "ʃiːp"),  # a long vowel: substitution of the segment
    ("mus", "muːst"),  # substitution and insertion
    ("tasa", "ta"),  # deletions
    ("", ""),  # both empty
    ("ami", ""),  # empty hypothesis
    ("", "pini"),  # empty reference
    ("t͡ʃiːz", "tʃiz"),  # a tie bar, two segments against one
    ("ðɪs ɪz", "dɪs iz"),  # spaces and two substitutions
    ("gɑ", "ɡɑ"),  # Latin g normalized to IPA ɡ
]


@pytest.mark.parametrize("ref,hyp", PAIRS)
def test_align_phones_matches_jax(ref, hyp):
    from whisper_ipa_tpu.metrics.analysis import align_phones as jax_align
    from whisper_ipa_torch.metrics.analysis import align_phones
    from whisper_ipa_torch.metrics.segment import tokenize_ipa

    r, h = tokenize_ipa(ref), tokenize_ipa(hyp)
    ops = align_phones(r, h)
    assert ops == jax_align(r, h)
    assert [x for op, x, _ in ops if op != "ins"] == r
    assert [y for op, _, y in ops if op != "del"] == h


def test_confusion_analysis_matches_jax():
    from whisper_ipa_tpu.metrics.analysis import (
        confusion_analysis as jax_confusion,
        print_confusion_report as jax_print,
    )
    from whisper_ipa_torch.metrics.analysis import (
        confusion_analysis,
        print_confusion_report,
    )

    refs, hyps = [r for r, _ in PAIRS], [h for _, h in PAIRS]
    ours, theirs = confusion_analysis(refs, hyps), jax_confusion(refs, hyps)
    assert ours == theirs
    assert ours["num_pairs"] == len(PAIRS)
    assert ours["top_insertions"] and ours["top_deletions"]
    assert ours["top_substitutions"]
    printed = []
    for fn, report in ((print_confusion_report, ours), (jax_print, theirs)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            fn(report)
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    empty = confusion_analysis([], [])
    assert empty == jax_confusion([], []) and empty["num_pairs"] == 0


# -- native cores against the NumPy/Python paths ---------------------------

needs_native = pytest.mark.skipif(
    not os.path.isfile(NATIVE_LIB),
    reason="native/libwipa_native.so is not built (make -C native)")


@needs_native
@pytest.mark.parametrize("m,n", [(0, 0), (0, 5), (7, 0), (1, 1), (12, 9),
                                 (40, 55)])
def test_levenshtein_native_numpy_jax(m, n):
    from whisper_ipa_tpu.metrics import native as jax_native
    from whisper_ipa_torch.metrics import native
    from whisper_ipa_torch.metrics.per import _levenshtein_numpy

    rng = np.random.default_rng(m * 100 + n)
    a = rng.integers(0, 6, m).tolist()
    b = rng.integers(0, 6, n).tolist()
    want = _levenshtein_numpy(a, b)
    assert native.levenshtein(a, b) == want == jax_native.levenshtein(a, b)


@needs_native
@pytest.mark.parametrize("ref,hyp", [p for p in PAIRS if p[0]])
def test_feature_distances_native_numpy_jax(monkeypatch, ref, hyp):
    """PER, PFER (the weighted DP) and cosine PFER: the port's native core,
    the port's NumPy path and the JAX package's native core agree."""
    import whisper_ipa_tpu.metrics as jax_metrics
    from whisper_ipa_torch.metrics import per, pfer

    assert per._native_levenshtein is not None
    assert pfer._native_weighted is not None and pfer._native_cosine is not None
    fns = ("phone_error_rate", "phone_feature_error_rate",
           "phone_feature_error_rate_cosine")
    mods = (per, pfer, pfer)
    native = [getattr(m, f)(ref, hyp) for m, f in zip(mods, fns)]
    theirs = [getattr(jax_metrics, f)(ref, hyp) for f in fns]
    for name in ("_native_weighted", "_native_cosine"):
        monkeypatch.setattr(pfer, name, None)
    monkeypatch.setattr(per, "_native_levenshtein", None)
    numpy_path = [getattr(m, f)(ref, hyp) for m, f in zip(mods, fns)]
    assert native[0] == numpy_path[0] == theirs[0]
    np.testing.assert_allclose(native, numpy_path, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(native, theirs, rtol=0, atol=0)


def _write_wav_file(path, audio, sr, channels=1, sampwidth=2):
    import wave

    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2") if sampwidth == 2 else (
        (pcm * 2147483647.0).astype("<i4"))
    frames = np.repeat(pcm[:, None], channels, axis=1).reshape(-1)
    with wave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(sampwidth)
        f.setframerate(sr)
        f.writeframes(frames.tobytes())


@needs_native
@pytest.mark.parametrize("sr,channels,sampwidth", [
    (16000, 1, 2), (16000, 2, 2), (16000, 1, 4), (8000, 1, 2), (44100, 2, 2),
])
def test_wav_native_python_jax(monkeypatch, tmp_path, sr, channels, sampwidth):
    """load_audio through the native decoder equals the JAX package's, and
    the Python decoder's within the reference's bounds (1e-3 at 16 kHz;
    resampled: the same length within 3 samples, correlation > 0.98)."""
    from whisper_ipa_tpu.audio import load_audio as jax_load_audio
    from whisper_ipa_tpu.audio import native as jax_native
    from whisper_ipa_torch.audio import io as port_io
    from whisper_ipa_torch.audio import native

    t = np.arange(int(0.5 * sr)) / sr
    audio = (0.4 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    path = str(tmp_path / "a.wav")
    _write_wav_file(path, audio, sr, channels, sampwidth)
    assert port_io._native_decode_wav is not None
    ours = port_io.load_audio(path)
    np.testing.assert_array_equal(ours, native.decode_wav_file(path))
    np.testing.assert_array_equal(ours, jax_native.decode_wav_file(path))
    np.testing.assert_array_equal(ours, jax_load_audio(path))
    monkeypatch.setattr(port_io, "_native_decode_wav", None)
    python = port_io.load_audio(path)
    assert abs(len(python) - len(ours)) <= 3
    n = min(len(python), len(ours))
    if sr == 16000:
        assert np.max(np.abs(python[:n] - ours[:n])) < 1e-3
    else:
        assert np.corrcoef(python[:n], ours[:n])[0, 1] > 0.98
    with pytest.raises(ValueError):
        native.decode_wav_bytes(b"not a wav at all")
