"""PyTorch port: ``examples/torch_generalization.py`` against
``examples/generalization.py``.

test-tiny at f32 on the CPU, the JAX package's weights carried across by
``params_from_numpy`` where the port's example and ``train()``
initialise: 8 train and 4 held-out utterances, 3 steps; the port writes
the JAX example's ``generalization.json`` keys with equal floor, train
and held-out PER/PFER and the final loss within 1e-4 relative.
"""

import json

import pytest
import torch

from test_torch_examples import bridge_init, load_example

torch.set_num_threads(1)


def test_generalization_matches_jax(tmp_path, monkeypatch):
    """The JAX example's train() on one device, as the port's runs (the
    tests' 8 virtual CPU devices would split its batch into shards)."""
    import whisper_ipa_tpu.train.loop as jax_loop

    jax_train = jax_loop.train
    monkeypatch.setattr(jax_loop, "train", lambda **kw: jax_train(
        data_parallel=False, **kw))
    argv = ["--model", "test-tiny", "--steps", "3", "--batch-size", "4",
            "--n-train", "8", "--n-heldout", "4", "--val-samples", "4"]
    load_example("generalization").main(argv + ["--out",
                                                str(tmp_path / "jax")])
    bridge_init(monkeypatch)
    got = load_example("torch_generalization").main(
        argv + ["--out", str(tmp_path / "port"), "--cpu"])
    with open(tmp_path / "jax" / "run" / "generalization.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "run" / "generalization.json") as f:
        assert json.load(f) == got
    assert list(got) == list(want)
    for k, v in want.items():
        if k == "final_loss":
            assert got[k] == pytest.approx(v, rel=1e-4)
        else:
            assert got[k] == v, k
