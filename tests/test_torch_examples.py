"""PyTorch port: the example programs' data, perturbations and small mains
against the JAX package's examples, and the invocation shims.

``examples/torch_*.py`` keep the JAX examples' seeds, so their data sets
(``make_dataset``, ``synth_split``) and perturbations (``add_noise``,
``add_reverb``, ``resynth_speaker`` and the composite ``perturb``) must
give the same entries, WAV bytes and arrays bit for bit.
``torch_minimal_finetune`` on the JAX package's test-tiny weights (carried
across by ``params_from_numpy``) gives the JAX example's five losses
within 1e-5 relative. Every example refuses the default device without a
card, and every ``scripts/torch_*.py`` answers ``--help``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_torch.models import params_from_numpy

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO_ROOT, "examples")
SHIMS = sorted(f for f in os.listdir(os.path.join(REPO_ROOT, "scripts"))
               if f.startswith("torch_") and f.endswith(".py"))


def load_example(name):
    """examples/<name>.py as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bridge_init(monkeypatch, seeds=(0, 1)):
    """The port's init_params (where the examples and train() call it)
    returns the JAX package's test-tiny tree for the same seed."""
    import whisper_ipa_torch.models as models
    import whisper_ipa_torch.train.loop as loop

    flat = {s: {k: np.asarray(v) for k, v in jax_flatten_params(
        jax_init_params(JAX_CONFIGS["test-tiny"], seed=s)).items()}
        for s in seeds}

    def init(cfg, seed=0, device=None):
        assert cfg.name == "test-tiny", cfg.name
        return params_from_numpy(flat[seed], device=device)

    monkeypatch.setattr(models, "init_params", init)
    monkeypatch.setattr(loop, "init_params", init)


def same_files(got_json, want_json, got_root, want_root):
    """Two pipeline JSONs hold the same entries (audio paths relative to
    their roots) and WAVs of the same bytes."""
    assert os.path.relpath(got_json, got_root) == os.path.relpath(
        want_json, want_root)
    with open(got_json) as f:
        got = json.load(f)
    with open(want_json) as f:
        want = json.load(f)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert os.path.relpath(g["audio_path"], got_root) == os.path.relpath(
            w["audio_path"], want_root)
        assert {k: v for k, v in g.items() if k != "audio_path"} == {
            k: v for k, v in w.items() if k != "audio_path"}
        with open(g["audio_path"], "rb") as fg, open(w["audio_path"],
                                                    "rb") as fw:
            assert fg.read() == fw.read(), g["audio_path"]


def test_make_dataset_sequences_are_generalization_examples():
    """torch_generalization.sequences draws the JAX example's phones and
    synthesis seeds (its WAVs are held in test_torch_synth)."""
    ours = load_example("torch_generalization")
    theirs = load_example("generalization")
    assert ours.PHONES == theirs.PHONES
    items = ours.sequences(256, 48)
    assert [len(v) for v in items.values()] == [256, 48]
    assert [s for _, s in items["heldout"]] == list(range(1_000_000,
                                                          1_000_048))
    seqs = [q for v in items.values() for q, _ in v]
    assert len(set(seqs)) == len(seqs)
    assert all(3 <= len(q) <= 8 for q in seqs)


REF_ENTRIES = [
    {"ipa_transcription": "kæt siː", "speaker_id": "spk_a", "locale": "fi",
     "dataset_source": "commonvoice"},
    {"ipa_transcription": "ʃuː aːm", "speaker_id": "spk_b", "locale": "ta"},
    {"ipa_transcription": "pata"},  # no speaker, locale or source
    {"ipa_transcription": "ɲeːlv", "speaker_id": "spk_a", "locale": "hu"},
]


def test_synth_split_matches_corpus_scale_example(tmp_path):
    ours = load_example("torch_corpus_scale")
    theirs = load_example("corpus_scale")
    for spk in ("spk_a", "spk_b", "7", ""):
        assert ours._speaker_f0(spk) == theirs._speaker_f0(spk)
    ref = tmp_path / "combined_train_ipa.json"
    ref.write_text(json.dumps(REF_ENTRIES, ensure_ascii=False))
    for side, mod in (("port", ours), ("jax", theirs)):
        mod.synth_split(str(ref), str(tmp_path / side / "train"),
                        str(tmp_path / side / "train.json"), 10_000_000)
    same_files(str(tmp_path / "port" / "train.json"),
               str(tmp_path / "jax" / "train.json"),
               str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.fixture(scope="module")
def waveform():
    from whisper_ipa_tpu.data.synth import synthesize_ipa

    return synthesize_ipa("kæt siː", seed=3).astype(np.float32)


@pytest.mark.parametrize("snr", [20.0, 10.0, 5.0])
def test_add_noise_bit_equal(waveform, snr):
    ours = load_example("torch_perturbed_eval")
    theirs = load_example("perturbed_eval")
    got = ours.add_noise(waveform, snr, np.random.default_rng(123_004))
    want = theirs.add_noise(waveform, snr, np.random.default_rng(123_004))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_add_reverb_bit_equal(waveform):
    ours = load_example("torch_perturbed_eval")
    theirs = load_example("perturbed_eval")
    got = ours.add_reverb(waveform, rng=np.random.default_rng(123_001))
    want = theirs.add_reverb(waveform, rng=np.random.default_rng(123_001))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("idx", [0, 5])
def test_resynth_speaker_bit_equal(idx):
    ours = load_example("torch_perturbed_eval")
    theirs = load_example("perturbed_eval")
    entry = {"ipa_transcription": "ʃuː aːm"}
    got = ours.resynth_speaker(entry, idx)
    want = theirs.resynth_speaker(entry, idx)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("cond", ["clean", "snr10+reverb", "reverb+snr5",
                                  "speaker", "speaker+snr20"])
def test_composite_perturb_bit_equal(waveform, cond):
    """The port's perturb against the JAX example's closure, rebuilt from
    its helpers: one default_rng(123_000 + idx), the parts in order."""
    ours = load_example("torch_perturbed_eval")
    theirs = load_example("perturbed_eval")
    entries = [{"ipa_transcription": "kæt"}, {"ipa_transcription": "siː"}]
    idx = 1
    want = waveform
    rng = np.random.default_rng(123_000 + idx)
    for part in cond.split("+"):
        if part.startswith("snr"):
            want = theirs.add_noise(want, float(part[3:]), rng)
        elif part == "reverb":
            want = theirs.add_reverb(want, rng=rng)
        elif part == "speaker":
            want = theirs.resynth_speaker(entries[idx], idx)
    got = ours.perturb(waveform, cond, idx, entries)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown condition"):
        ours.perturb(waveform, "snr10+echo", idx, entries)


def test_minimal_finetune_losses_match_jax(monkeypatch):
    """Five train steps on the seeded batch: the port's losses within 1e-5
    relative of the JAX example's (read from its train_step calls)."""
    import whisper_ipa_tpu.train as jax_train

    want = []
    step = jax_train.train_step

    def recording_step(*a, **kw):
        state, loss = step(*a, **kw)
        want.append(float(loss))
        return state, loss

    monkeypatch.setattr(jax_train, "train_step", recording_step)
    load_example("minimal_finetune").main()
    bridge_init(monkeypatch, seeds=(0,))
    got = load_example("torch_minimal_finetune").main(["--cpu"])
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_inference_latency_runs_on_the_cpu(capsys):
    r = load_example("torch_inference_latency").main(["test-tiny", "--device",
                                                      "cpu"])
    assert r["model"] == "test-tiny" and r["steady_s"] > 0
    assert r["audio_s"] > 0.5 and isinstance(r["text"], str)
    assert "steady state" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is here")
@pytest.mark.parametrize("name, argv", [
    ("torch_generalization", ["--out", "OUT"]),
    ("torch_perturbed_eval", ["--run-dir", "OUT", "--data", "OUT/x.json"]),
    ("torch_corpus_report", ["--run-dir", "OUT", "--data", "OUT/x.json"]),
    ("torch_corpus_scale", ["--out", "OUT", "--ref-dir", "OUT"]),
    ("torch_inference_latency", []),
    ("torch_minimal_finetune", []),
])
def test_examples_refuse_the_card_without_cuda(tmp_path, name, argv):
    """Without a card the default device raises before any work (nothing
    falls back to the CPU); --synth-only needs no device."""
    argv = [a.replace("OUT", str(tmp_path)) for a in argv]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        load_example(name).main(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("shim", SHIMS)
def test_shim_help(shim):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", shim), "--help"],
        capture_output=True, text=True, timeout=120,
        cwd=str(os.path.dirname(REPO_ROOT)))
    assert out.returncode == 0, out.stderr
    # evaluate_ipa takes no arguments: it runs the metrics' self-test
    assert out.stdout.startswith("usage:") or (
        shim == "torch_evaluate_ipa.py" and "All tests passed!" in out.stdout)


def test_every_script_has_a_shim():
    """scripts/<name>.py and the root calculate_real_speed.py each have a
    scripts/torch_<name>.py that calls whisper_ipa_torch.cli.<name>.main."""
    names = sorted(f[:-3] for f in os.listdir(os.path.join(REPO_ROOT,
                                                           "scripts"))
                   if f.endswith(".py") and not f.startswith("torch_"))
    want = sorted(names + ["calculate_real_speed"])
    assert [s[len("torch_"):-3] for s in SHIMS] == want
    for name in want:
        src = open(os.path.join(REPO_ROOT, "scripts",
                                f"torch_{name}.py")).read()
        assert f"from whisper_ipa_torch.cli.{name} import main" in src
