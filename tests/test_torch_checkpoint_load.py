"""PyTorch port: the checkpoint loader against the JAX package's, on the CPU.

Checkpoints are written by the JAX package (``save_safetensors``, MLX
names; and one HF-layout file), beside a ``training_config.json`` that
records ``freeze_encoder`` true, false or nothing. The port's
``load_checkpoint_auto`` must pick the same overlay, count the same
tensors and give the same tensors as the JAX package's, for auto,
decoder-only and full; a shape mismatch and a mismatched vocabulary
provenance raise, and the override variable turns the latter into one
warning.
"""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from safetensors.numpy import save_file

import whisper_ipa_torch.models.convert as port_convert
from tests.test_checkpoint_fixtures import to_hf_flat
from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import (
    load_checkpoint_auto as jax_load_checkpoint_auto,
)
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save
from whisper_ipa_torch.models import (
    checkpoint_overlay_mode,
    flatten_params,
    load_checkpoint_auto,
    params_from_numpy,
)

torch.set_num_threads(1)

JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)


def _np(flat):
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def base_jax():
    return jax_init_params(JCFG, seed=0)


@pytest.fixture(scope="module")
def trained_jax():
    return jax_init_params(JCFG, seed=1)


@pytest.fixture()
def base(base_jax):
    return params_from_numpy(_np(jax_flatten_params(base_jax)))


def _run_dir(root, name, freeze, trained_jax, hf=False):
    """<root>/<name>/checkpoint-5/model.safetensors, with the run's
    training_config.json recording ``freeze`` (None: the key is absent)."""
    run = os.path.join(str(root), name)
    ckpt = os.path.join(run, "checkpoint-5")
    os.makedirs(ckpt)
    if hf:
        save_file(to_hf_flat(trained_jax), os.path.join(ckpt, "model.safetensors"))
    else:
        jax_save(os.path.join(ckpt, "model.safetensors"), trained_jax)
    args = {"model_name": "test-tiny"}
    if freeze is not None:
        args["freeze_encoder"] = freeze
    with open(os.path.join(run, "training_config.json"), "w") as f:
        json.dump({"training_args": args}, f)
    return ckpt


def _assert_same(port_params, n, jax_params, jn):
    assert n == jn
    got = flatten_params(port_params)
    want = _np(jax_flatten_params(jax_params))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("freeze,full,want_full", [
    (True, None, False),   # auto: frozen encoder -> decoder-only
    (False, None, True),   # auto: trained encoder -> full
    (None, None, False),   # auto, no metadata -> the reference contract
    (False, False, False),  # --decoder-only overrides
    (True, True, True),    # --full-checkpoint overrides
])
@pytest.mark.parametrize("hf", [False, True], ids=["mlx", "hf"])
def test_load_matches_jax(tmp_path, base, base_jax, trained_jax, freeze, full,
                          want_full, hf):
    ckpt = _run_dir(tmp_path, "run", freeze, trained_jax, hf=hf)
    assert checkpoint_overlay_mode(ckpt) == (None if freeze is None else not freeze)
    got, n = load_checkpoint_auto(ckpt, base, full)
    want, jn = jax_load_checkpoint_auto(ckpt, base_jax, full)
    _assert_same(got, n, want, jn)
    flat = flatten_params(got)
    trained = _np(jax_flatten_params(trained_jax))
    n_dec = sum(k.startswith("decoder.") for k in trained)
    assert n == (len(trained) if want_full else n_dec)
    enc = next(k for k in flat if k.startswith("encoder.blocks"))
    src = trained if want_full else _np(jax_flatten_params(base_jax))
    np.testing.assert_array_equal(flat[enc].numpy(), src[enc])


def test_weights_file_path_and_device(tmp_path, base, trained_jax):
    """A .safetensors path loads like its directory; results stay on the
    base tensors' device (the CPU here)."""
    ckpt = _run_dir(tmp_path, "run", True, trained_jax)
    a, n = load_checkpoint_auto(ckpt, base)
    b, m = load_checkpoint_auto(os.path.join(ckpt, "model.safetensors"), base)
    assert n == m
    for name, t in flatten_params(a).items():
        assert torch.equal(t, flatten_params(b)[name])
        assert t.device == torch.device("cpu")


def test_shape_mismatch_raises(tmp_path, base):
    wide = jax_init_params(replace(JCFG, n_text_ctx=64), seed=1)
    ckpt = os.path.join(str(tmp_path), "wide")
    os.makedirs(ckpt)
    jax_save(os.path.join(ckpt, "model.safetensors"), wide)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint_auto(ckpt, base)


def _stamp(ckpt, provenance):
    with open(os.path.join(ckpt, "training_state.json"), "w") as f:
        json.dump({"step": 5, "vocab_provenance": provenance}, f)


def test_vocab_provenance_guard(tmp_path, base, trained_jax, monkeypatch,
                                capsys):
    from whisper_ipa_torch.tokenizer import get_tokenizer

    ckpt = _run_dir(tmp_path, "run", True, trained_jax)
    _stamp(ckpt, get_tokenizer(multilingual=True).provenance)
    load_checkpoint_auto(ckpt, base)  # matching stamp: loads

    _stamp(ckpt, "tiktoken:0000000000000000")
    monkeypatch.delenv("WHISPER_IPA_TPU_ALLOW_VOCAB_MISMATCH", raising=False)
    with pytest.raises(ValueError, match="vocabulary"):
        load_checkpoint_auto(ckpt, base)

    monkeypatch.setenv("WHISPER_IPA_TPU_ALLOW_VOCAB_MISMATCH", "1")
    monkeypatch.setattr(port_convert, "_vocab_mismatch_warned", False)
    capsys.readouterr()
    _, n = load_checkpoint_auto(ckpt, base)
    _, m = load_checkpoint_auto(ckpt, base)
    assert n == m > 0
    assert capsys.readouterr().err.count("WARNING:") == 1
