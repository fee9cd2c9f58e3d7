"""PyTorch port: the formant synthesizer against the JAX package's.

``whisper_ipa_torch.data.synth`` is NumPy and SciPy only, so for the same
arguments and seed its waveforms (and alignments) must equal
``whisper_ipa_tpu.data.synth``'s bit for bit: every phone of the
synthesizer's tables and some it does not know, and a seeded grid of IPA
strings (diacritics, ties, length, nasalization, devoicing), durations, f0
and seeds. ``examples/torch_generalization.make_dataset`` must give the
same entries and WAV bytes as ``examples/generalization.make_dataset``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

import whisper_ipa_tpu.data.synth as jax_synth
import whisper_ipa_torch.data.synth as synth

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IPAS = ["kæt", "ʃip", "aːm", "ə̥tʃ", "t͡ʃiːz", "ŋ̊ʷa", "bʌtn̩", "ĩɾõ", "ʘʔq",
        "ðɪs ɪz", "ɡɯɣ", "wɔːtɚ"]
# (duration, f0, seed) triples, drawn once from a seeded generator; a stop
# needs 70 ms (closure + burst), see test_short_stop_raises_in_both
_rng = np.random.default_rng(11)
SETTINGS = [(0.12, 120.0, 0)] + [
    (round(float(_rng.uniform(0.08, 0.25)), 3),
     round(float(_rng.uniform(70.0, 260.0)), 1), int(_rng.integers(0, 2**31)))
    for _ in range(3)
]
PHONES = sorted(
    set(jax_synth._VOWEL_FORMANTS) | set(jax_synth._SONORANT_FORMANTS)
    | set(jax_synth._FRICATIVES) | set(jax_synth._STOPS)
) + ["aː", "ĩ", "i̥", "n̊", "ʘ", ""]


def load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sample_rate_and_tables():
    assert synth.SAMPLE_RATE == jax_synth.SAMPLE_RATE
    for table in ("_VOWEL_FORMANTS", "_SONORANT_FORMANTS", "_FRICATIVES",
                  "_STOPS"):
        assert getattr(synth, table) == getattr(jax_synth, table), table


@pytest.mark.parametrize("phone", PHONES)
def test_synthesize_phone_bit_equal(phone):
    for duration, f0, seed in SETTINGS:
        got = synth.synthesize_phone(phone, duration=duration, f0=f0,
                                     rng=np.random.default_rng(seed))
        want = jax_synth.synthesize_phone(phone, duration=duration, f0=f0,
                                          rng=np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), (phone, duration, f0, seed)


@pytest.mark.parametrize("setting", SETTINGS, ids=str)
@pytest.mark.parametrize("ipa", IPAS)
def test_synthesize_ipa_and_alignment_bit_equal(ipa, setting):
    duration, f0, seed = setting
    kw = dict(duration=duration, f0=f0, seed=seed)
    assert np.array_equal(synth.synthesize_ipa(ipa, **kw),
                          jax_synth.synthesize_ipa(ipa, **kw))
    phones = synth.tokenize_ipa(ipa)
    assert np.array_equal(synth.synthesize_phonemes(phones, **kw),
                          jax_synth.synthesize_phonemes(phones, **kw))
    audio, align = synth.synthesize_phonemes_with_alignment(phones, **kw)
    j_audio, j_align = jax_synth.synthesize_phonemes_with_alignment(phones,
                                                                    **kw)
    assert np.array_equal(audio, j_audio)
    assert align == j_align
    # the alignment tiles the waveform, phone by phone
    assert [a[0] for a in align] == phones
    assert align[0][1] == 0.0 and align[-1][2] == len(audio) / synth.SAMPLE_RATE
    assert all(a[2] == b[1] for a, b in zip(align, align[1:]))


def test_short_stop_raises_in_both():
    """Both packages refuse a stop shorter than its 50 ms closure plus 20
    ms burst with the same error (the reference's behaviour, kept)."""
    for module in (synth, jax_synth):
        with pytest.raises(ValueError, match="broadcast"):
            module.synthesize_phone("b", duration=0.05)


def test_empty_sequence():
    audio, align = synth.synthesize_phonemes_with_alignment([])
    j_audio, j_align = jax_synth.synthesize_phonemes_with_alignment([])
    assert np.array_equal(audio, j_audio) and align == j_align == []


@pytest.mark.parametrize("text, subs", [
    ("bʌɾɚ", {"ɾ": "t"}),
    ("ʃip", {"ʃ": "s", "i": "ɪ"}),
])
def test_pronunciation_variants_bit_equal(text, subs):
    got = synth.pronunciation_variants(text, subs, seed=5, f0=140.0)
    want = jax_synth.pronunciation_variants(text, subs, seed=5, f0=140.0)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2:] == want[2:]


def test_learning_set_matches_generalization_example(tmp_path):
    """examples/torch_generalization.make_dataset (the port's, which
    chip_smoke.py's learning phase loads) and examples/generalization's
    make_dataset (the JAX package) write the same entries and WAV bytes."""
    port = load_by_path("torch_generalization_under_test",
                        os.path.join(REPO_ROOT, "examples",
                                     "torch_generalization.py"))
    example = load_by_path("generalization_under_test",
                           os.path.join(REPO_ROOT, "examples",
                                        "generalization.py"))
    assert port.PHONES == example.PHONES
    port_root, jax_root = tmp_path / "port", tmp_path / "jax"
    got = port.make_dataset(str(port_root), 8, 4)
    want = example.make_dataset(str(jax_root), 8, 4)
    for got_json, want_json, root_g, root_w in zip(
            got, want, (port_root,) * 2, (jax_root,) * 2):
        assert os.path.relpath(got_json, root_g) == os.path.relpath(
            want_json, root_w)
        with open(got_json) as f:
            got_entries = json.load(f)
        with open(want_json) as f:
            want_entries = json.load(f)
        assert len(got_entries) == len(want_entries) > 0
        for g, w in zip(got_entries, want_entries):
            assert os.path.relpath(g["audio_path"], root_g) == os.path.relpath(
                w["audio_path"], root_w)
            assert {k: v for k, v in g.items() if k != "audio_path"} == {
                k: v for k, v in w.items() if k != "audio_path"}
            with open(g["audio_path"], "rb") as fg, open(w["audio_path"],
                                                        "rb") as fw:
                assert fg.read() == fw.read(), g["audio_path"]
