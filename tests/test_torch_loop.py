"""PyTorch port: ``train()`` and its CLI end to end on the CPU, against the
JAX package's ``train()``.

The same test-tiny weights file, the same tiny JSON of WAVs, float32,
4 steps with one validation and one checkpoint: the logged losses match
within 1e-5 relative, and both runs leave the same files and CSV columns.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save_safetensors
from whisper_ipa_tpu.train.loop import train as jax_train
from whisper_ipa_torch.cli import train_whisper_ipa as cli
from whisper_ipa_torch.train import train

from test_torch_data import write_dataset

torch.set_num_threads(1)

COMMON = dict(
    model_name="test-tiny",
    num_steps=4,
    batch_size=2,
    learning_rate=1e-4,
    validate_every=4,
    save_every=4,
    final_validate=False,
    seed=3,
)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    data = write_dataset(str(root / "ds"), n=4, seconds=0.3)
    weights = str(root / "test-tiny.safetensors")
    jax_save_safetensors(weights, jax_init_params(JAX_CONFIGS["test-tiny"], seed=0))
    return data, weights


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_train_matches_jax(inputs, tmp_path):
    data, weights = inputs
    kw = dict(COMMON, train_data_path=data, test_data_path=data, weights=weights)
    ours = train(output_dir=str(tmp_path / "torch"), device="cpu", **kw)
    ref = jax_train(output_dir=str(tmp_path / "jax"), data_parallel=False, **kw)
    assert ours["final_loss"] == pytest.approx(ref["final_loss"], rel=1e-5)

    heads, losses = {}, {}
    for side in ("torch", "jax"):
        out = tmp_path / side
        for name in ("training_config.json", "training_summary.json",
                     "training_log.csv", "validation_log.csv"):
            assert (out / name).is_file(), (side, name)
        for name in ("model.safetensors", "training_state.json",
                     "opt_state.safetensors"):
            assert (out / "checkpoint-4" / name).is_file(), (side, name)
        head, rows = _csv(out / "training_log.csv")
        vhead, vrows = _csv(out / "validation_log.csv")
        heads[side] = (head, vhead)
        losses[side] = [float(r[1]) for r in rows]
        assert [int(r[0]) for r in rows] == [1, 2, 3, 4]
        assert [int(r[0]) for r in vrows] == [4]
        meta = json.load(open(out / "checkpoint-4" / "training_state.json"))
        assert meta["step"] == 4 and meta["vocab_provenance"]
    assert heads["torch"] == heads["jax"]
    # the CSV keeps 6 decimals, so compare at that resolution too
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5, atol=2e-6)


def test_cli_trains_and_resumes_on_cpu(inputs, tmp_path):
    """The port's CLI with --device cpu, then --resume to a later step."""
    data, weights = inputs
    out = str(tmp_path / "cli")
    argv = ["--model", "test-tiny", "--train-data", data, "--test-data", data,
            "--output-dir", out, "--batch-size", "2", "--lr", "1e-4",
            "--validate-every", "0", "--save-every", "2", "--weights", weights,
            "--device", "cpu", "--unfreeze-encoder", "--blockwise-loss"]
    cli.main(argv + ["--steps", "2"])
    assert os.path.isdir(os.path.join(out, "checkpoint-2"))
    cli.main(argv + ["--steps", "3", "--resume"])
    _, rows = _csv(os.path.join(out, "training_log.csv"))
    assert [int(r[0]) for r in rows] == [1, 2, 3]
    cfg = json.load(open(os.path.join(out, "training_config.json")))
    assert cfg["training_args"]["freeze_encoder"] is False


@pytest.mark.parametrize(
    "flags", [["--zero1"], ["--fsdp"], ["--tensor-parallel", "2"],
              ["--steps-per-call", "4"]],
)
def test_cli_refuses_multi_device_flags(flags, inputs, tmp_path, capsys):
    """On one process, as in the reference on one device: --zero1 and
    --fsdp have no data axis and are ignored with its message (the run
    trains), --tensor-parallel 2 does not divide one device, and
    --steps-per-call > 1 is not ported. The multi-process runs are
    tests/test_torch_multirank.py's."""
    data, weights = inputs
    argv = flags + ["--device", "cpu", "--model", "test-tiny", "--train-data",
                    data, "--test-data", data, "--output-dir", str(tmp_path),
                    "--steps", "1", "--batch-size", "2", "--validate-every",
                    "0", "--save-every", "0", "--weights", weights]
    if flags[0] == "--steps-per-call":
        with pytest.raises(SystemExit):
            cli.main(argv)
        assert "ROADMAP" in capsys.readouterr().err
    elif flags[0] == "--tensor-parallel":
        with pytest.raises(ValueError, match="model=2 does not divide 1"):
            cli.main(argv)
    else:
        cli.main(argv)
        name = "ZeRO-1" if flags[0] == "--zero1" else "FSDP"
        assert (f"{name} requested but no data-parallel mesh axis; ignoring"
                in capsys.readouterr().out)


def test_train_needs_a_card_unless_told_cpu(inputs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, weights = inputs
    with pytest.raises(RuntimeError, match="cpu"):
        train(output_dir=str(tmp_path), train_data_path=data,
              test_data_path=data, weights=weights, **COMMON)
