"""PyTorch port: the example mains that score and the corpus-scale
program, against the JAX package's examples on the same inputs.

test-tiny at f32 on the CPU, the JAX package's weights carried across by
``params_from_numpy`` where the port's examples and ``train()``
initialise: ``torch_perturbed_eval`` (all seven conditions) and
``torch_corpus_report`` on one JAX-written checkpoint give the JAX
examples' scores, run as ``tests/test_corpus_report.py`` runs them
(``runpy``); ``torch_corpus_scale`` runs its three stages on a small
corpus in the reference's schema and resumes.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import init_params as jax_init_params

from test_torch_examples import EXAMPLES, bridge_init, load_example

torch.set_num_threads(1)

HELDOUT = [("pat", "fi"), ("tak", "fi"), ("ki", "ta")]


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A JAX-written test-tiny checkpoint as <run>/best-checkpoint, and
    three synthesized utterances with locales. The checkpoint is the seed-0
    tree with the embedding rows of five phones scaled by 5 (a random
    model's text is empty): its greedy output is those phones, so the
    scores are not all 100%."""
    import jax.numpy as jnp

    from whisper_ipa_tpu.audio import write_wav
    from whisper_ipa_tpu.data.synth import synthesize_ipa
    from whisper_ipa_tpu.tokenizer import get_tokenizer
    from whisper_ipa_tpu.train.checkpoints import save_checkpoint
    from whisper_ipa_tpu.train.step import create_train_state

    root = tmp_path_factory.mktemp("scored")
    cfg = JAX_CONFIGS["test-tiny"]
    params = jax_init_params(cfg, seed=0)
    tok = get_tokenizer(multilingual=cfg.multilingual,
                        num_languages=cfg.num_languages)
    ids = [tok.encode(p)[0] for p in "patki"]
    emb = np.asarray(params["decoder"]["token_embedding"]).copy()
    emb[ids] *= 5.0
    params = dict(params, decoder=dict(params["decoder"],
                                       token_embedding=jnp.asarray(emb)))
    state, _ = create_train_state(params)
    save_checkpoint(state, 1, 1.0, str(root / "ck"), save_opt_state=False)
    os.makedirs(root / "run")
    os.rename(root / "ck" / "checkpoint-1", root / "run" / "best-checkpoint")
    data = []
    for i, (ipa, loc) in enumerate(HELDOUT):
        path = str(root / f"c{i}.wav")
        write_wav(path, synthesize_ipa(ipa, seed=i))
        data.append({"audio_path": path, "ipa_transcription": ipa,
                     "locale": loc})
    with open(root / "test.json", "w") as f:
        json.dump(data, f, ensure_ascii=False)
    return root


def run_jax_example(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name="__main__")


def test_perturbed_eval_matches_jax(scored, tmp_path, monkeypatch):
    """All seven conditions at batch 2 (a padded tail batch)."""
    argv = ["--run-dir", str(scored / "run"), "--data",
            str(scored / "test.json"), "--model", "test-tiny", "--batch", "2",
            "--sample-len", "8"]
    run_jax_example(monkeypatch, "perturbed_eval",
                    argv + ["--out", str(tmp_path / "jax.json")])
    bridge_init(monkeypatch)
    got = load_example("torch_perturbed_eval").main(
        argv + ["--out", str(tmp_path / "port.json"), "--cpu"])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert list(got["conditions"]) == list(want["conditions"]) == [
        "clean", "snr20", "snr10", "snr5", "reverb", "snr10+reverb",
        "speaker"]
    assert got["n"] == want["n"] == len(HELDOUT)
    for cond, w in want["conditions"].items():
        g = got["conditions"][cond]
        assert list(g) == list(w)
        assert {k: g[k] for k in ("per", "pfer", "per_std", "pfer_std")} == {
            k: w[k] for k in ("per", "pfer", "per_std", "pfer_std")}, cond
        assert np.isfinite(g["per"]) and np.isfinite(g["pfer"])


def test_corpus_report_matches_jax(scored, tmp_path, monkeypatch):
    """Batch 2 over 3 utterances: one full batch, a padded tail, and the
    locale join, each utterance scored once."""
    argv = ["--run-dir", str(scored / "run"), "--data",
            str(scored / "test.json"), "--model", "test-tiny", "--batch", "2",
            "--sample-len", "8"]
    run_jax_example(monkeypatch, "corpus_report",
                    argv + ["--out", str(tmp_path / "jax.json")])
    bridge_init(monkeypatch)
    got = load_example("torch_corpus_report").main(
        argv + ["--out", str(tmp_path / "port.json"), "--cpu"])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert list(got) == list(want)
    assert got["n_scored"] == 3
    assert got["by_locale"]["fi"]["n"] == 2 and got["by_locale"]["ta"]["n"] == 1
    for k in want:
        assert got[k] == want[k], k


def test_corpus_scale_stages_and_resume(tmp_path, monkeypatch, capsys):
    """Synthesis, floor, training and the report at test-tiny on a corpus of
    6 + 2 entries in the reference's schema; a second run with more steps
    skips the synthesis and resumes from the first run's last checkpoint."""
    ref = tmp_path / "ref"
    os.makedirs(ref)
    corpus = [{"ipa_transcription": ipa, "speaker_id": f"spk{i % 3}",
               "locale": ("fi", "ta", "hu")[i % 3]}
              for i, ipa in enumerate(["pata", "kisu", "mono", "lati",
                                       "supa", "tomi", "nuka", "pesi"])]
    with open(ref / "combined_train_ipa.json", "w") as f:
        json.dump(corpus[:6], f)
    with open(ref / "combined_test_ipa.json", "w") as f:
        json.dump(corpus[6:], f)
    bridge_init(monkeypatch)
    argv = ["--batch-size", "2", "--val-samples", "2", "--validate-every",
            "2", "--steps-per-call", "2", "--out", str(tmp_path / "corpus"),
            "--ref-dir", str(ref), "--model", "test-tiny", "--cpu"]
    example = load_example("torch_corpus_scale")
    first = example.main(argv + ["--steps", "2"])
    jax_keys = ["model", "steps", "batch_size", "n_train", "n_heldout_scored",
                "floor_per", "floor_pfer", "heldout_per", "heldout_pfer",
                "final_loss"]
    assert list(first) == jax_keys
    assert first["n_train"] == 6 and np.isfinite(first["final_loss"])
    assert np.isfinite(first["floor_per"]) and np.isfinite(first["heldout_per"])
    with open(tmp_path / "corpus" / "run_test-tiny" / "corpus_scale.json") as f:
        assert json.load(f) == first
    capsys.readouterr()
    second = example.main(argv + ["--steps", "4", "--skip-floor"])
    out = capsys.readouterr().out
    assert out.count("exists, skipping synthesis") == 2
    assert "checkpoint-2 at step 2" in out
    assert second["steps"] == 4 and second["floor_per"] is None
    assert np.isfinite(second["final_loss"])
    with open(tmp_path / "corpus" / "run_test-tiny" / "training_log.csv") as f:
        assert [r.split(",")[0] for r in f.read().split()[1:]] == [
            "1", "2", "3", "4"]
