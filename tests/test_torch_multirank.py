"""PyTorch port: the entry points over a gloo world of 2 CPU ranks, against
the JAX package.

One launch of ``tests/torch_ranks.py`` (torchrun's environment, so every
entry point joins the group as under torchrun) runs, in order:

* ``validate(mesh=)`` with data 2 and ``cli.evaluate_model.evaluate_model``
  called in the reference's positional order with ``data_parallel=True``:
  the same PER/PFER and hypotheses as the JAX package on one device, with
  a tail batch padded to the data axis;
* checkpoints: a one-rank state after two steps restored into a ZeRO-1 and
  an FSDP layout (each rank's slices) and saved again gives the one-rank
  files byte for byte, which the JAX package restores; a JAX-written
  checkpoint restored into the FSDP layout gathers back to JAX's state;
* ``cli.serve --dp 2`` and ``--tp 2`` (micro-batch service, f32): rank 0
  answers HTTP requests with the JAX service's texts while rank 1 follows;
* ``cli.train_whisper_ipa --tensor-parallel 2`` (its losses are the JAX
  ``train()``'s on one device), ``--zero1`` and ``--fsdp``.
"""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models.convert import flatten_params as jax_flatten
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save_safetensors

import torch_ranks
from test_torch_data import write_dataset

torch.set_num_threads(1)

FIELDS = dict(n_audio_ctx=32, n_text_ctx=32)
JCFG = replace(JAX_CONFIGS["test-tiny"], **FIELDS)
# the validation model: 30 s mels, micro widths (tests/test_parallel.py's)
VAL_FIELDS = dict(n_audio_state=32, n_audio_layer=1, n_text_state=32,
                  n_text_layer=1, n_text_ctx=48)
EOT = 50257
TRAIN_FLAGS = {
    "tp2": ["--tensor-parallel", "2"],
    "zero1": ["--zero1"],
    "fsdp": ["--fsdp"],
    "dp2": [],
    "dp2_spc4": ["--steps-per-call", "4"],
}


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _npz(path, params):
    np.savez(path, **{k: np.asarray(v) for k, v in jax_flatten(params).items()})
    return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("multirank")
    data = write_dataset(str(root / "ds"), n=6, seconds=0.3)
    weights = str(root / "test-tiny.safetensors")
    jax_save_safetensors(weights, jax_init_params(JAX_CONFIGS["test-tiny"], seed=0))
    rng = np.random.default_rng(3)
    tokens = np.tile([[50258, 50259, 50359, 50363, 100, 200, EOT, EOT]],
                     (4, 1)).astype(np.int32)
    plan = dict(
        params_npz=_npz(str(root / "p.npz"), jax_init_params(JCFG, seed=0)),
        val_params_npz=_npz(str(root / "v.npz"), jax_init_params(
            replace(JAX_CONFIGS["test-tiny"], **VAL_FIELDS), seed=0)),
        cfg=FIELDS, val_cfg=VAL_FIELDS, eot=EOT, dataset=data, weights=weights,
        wavs=[e["audio_path"] for e in _read_json(data)][:3],
        batch4=dict(mel=rng.standard_normal((4, 64, 80)).astype(np.float32),
                    tokens=tokens),
        scenarios=[
            ("validate", "validate", dict(data=2)),
            ("checkpoints", "checkpoints", {}),
            ("serve_dp2", "service", dict(dp=2, tp=1)),
            ("serve_tp2", "service", dict(dp=1, tp=2)),
        ] + [(f"train_{k}", "train_cli", dict(flags=v))
             for k, v in TRAIN_FLAGS.items()],
    )
    plan["jax_ckpt"], ref_state = _jax_checkpoint(plan, root)
    handle = torch_ranks.start(2, plan, str(root / "w2"))
    ref = _jax_references(plan, root)
    ranks, logs = torch_ranks.collect(handle)
    ref["jax_state"] = ref_state
    return dict(ranks=ranks, logs=logs, ref=ref, root=root, plan=plan)


def _jax_checkpoint(plan, root):
    """The JAX package's state after 2 full fine-tune steps on batch4,
    saved; returns (its checkpoint directory, the state)."""
    import jax.numpy as jnp

    from whisper_ipa_tpu.train import checkpoints as jax_ckpt
    from whisper_ipa_tpu.train import create_train_state, train_step

    state, tx = create_train_state(jax_init_params(JCFG, seed=0),
                                   learning_rate=1e-3, freeze_encoder=False)
    b = plan["batch4"]
    for _ in range(2):
        state, _ = train_step(state, jnp.asarray(b["mel"]),
                              jnp.asarray(b["tokens"]), JCFG, tx, EOT,
                              freeze_encoder=False)
    return jax_ckpt.save_checkpoint(state, 2, 1.0, str(root / "jax")), state


def _jax_references(plan, root):
    from whisper_ipa_tpu.cli.evaluate_model import evaluate_model
    from whisper_ipa_tpu.data import create_data_loader
    from whisper_ipa_tpu.models.convert import load_safetensors_flat, params_from_flat
    from whisper_ipa_tpu.serve import TranscriptionService
    from whisper_ipa_tpu.train.loop import train, validate

    vcfg = replace(JAX_CONFIGS["test-tiny"], **VAL_FIELDS)
    vparams = jax_init_params(vcfg, seed=0)
    dataset = create_data_loader(plan["dataset"], n_mels=80)
    ref = dict(
        validate=validate(vparams, vcfg, dataset, dataset.tokenizer,
                          num_samples=6, val_batch_size=4),
        evaluate=evaluate_model(vparams, vcfg, plan["dataset"], 5, "Model", 2,
                                "en", False),
    )
    # the reference's hypotheses: its decode on the same batches of 2
    from whisper_ipa_tpu.decode import DecodingOptions, decode
    from whisper_ipa_tpu.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=True, language="en")
    opts = DecodingOptions(language="en", without_timestamps=True)
    ref["hypotheses"] = [
        r.text.strip()
        for start in (0, 2, 4)
        for r in decode(vparams, vcfg, dataset.get_batch(
            list(range(start, min(start + 2, 5))))["mel_features"], opts,
            tokenizer=tok)
    ]
    service = TranscriptionService(
        params_from_flat(load_safetensors_flat(plan["weights"])),
        JAX_CONFIGS["test-tiny"], batch_size=4, bf16=False)
    try:
        ref["serve"] = [service.transcribe(p)["text"] for p in plan["wavs"]]
    finally:
        service.close()
    ref["train_tp2"] = train(
        model_name="test-tiny", train_data_path=plan["dataset"],
        test_data_path=plan["dataset"], output_dir=str(root / "jax_run"),
        num_steps=2, batch_size=2, learning_rate=1e-4, validate_every=2,
        save_every=2, weights=plan["weights"], data_parallel=False, seed=3)
    return ref


def test_dp_validate_matches_jax(world):
    want = world["ref"]["validate"]
    for rank in world["ranks"]:
        got = rank["validate"]["validate"]
        assert got["per"] == pytest.approx(want["per"], abs=1e-9)
        assert got["pfer"] == pytest.approx(want["pfer"], abs=1e-9)
        assert got["num_samples"] == want["num_samples"] == 6


def test_dp_evaluate_model_positional_matches_jax(world):
    """The reference's positional call with data_parallel=True: greedy
    hypotheses of 5 samples in batches of 2 (the tail padded to 2 rows)."""
    want = world["ref"]["evaluate"]
    for rank in world["ranks"]:
        got = rank["validate"]
        assert got["hypotheses"] == world["ref"]["hypotheses"]
        assert got["per"] == pytest.approx(want["per"], abs=1e-9)


@pytest.mark.parametrize("kind", ["zero1", "fsdp"])
def test_sharded_checkpoint_is_the_one_rank_file(world, kind):
    root = world["root"] / "w2" / "checkpoints"
    one = root / "one" / "checkpoint-2"
    ours = root / kind / "checkpoint-2"
    for name in ("model.safetensors", "opt_state.safetensors"):
        assert (ours / name).read_bytes() == (one / name).read_bytes(), name
    shapes = world["ranks"][1]["checkpoints"][kind]
    # each rank restored its slice of the (64, 256) mlp1 (zero1_spec's
    # largest divisible axis); FSDP's parameter too
    assert shapes["mu"] == (64, 128)
    assert shapes["w"] == ((64, 128) if kind == "fsdp" else (64, 256))


def test_sharded_checkpoint_restores_in_jax(world):
    from whisper_ipa_tpu.train import checkpoints as jax_ckpt
    from whisper_ipa_tpu.train import create_train_state

    ckpt = str(world["root"] / "w2" / "checkpoints" / "fsdp" / "checkpoint-2")
    template, _ = create_train_state(jax_init_params(JCFG, seed=0),
                                     learning_rate=1e-3, freeze_encoder=False)
    restored, meta = jax_ckpt.restore_checkpoint(ckpt, template)
    assert meta["step"] == 2 and int(restored.step) == 2
    one = str(world["root"] / "w2" / "checkpoints" / "one" / "checkpoint-2")
    again, _ = jax_ckpt.restore_checkpoint(one, template)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mu = jax_flatten(restored.opt_state[1][0].mu)
    assert np.abs(np.asarray(mu["decoder.blocks.0.mlp1.w"])).max() > 0


def test_jax_checkpoint_restores_into_fsdp(world):
    """Both ways: a JAX-written checkpoint restored into the FSDP layout
    (each rank's slices) gathers back to JAX's state exactly."""
    got = world["ranks"][0]["checkpoints"]["from_jax"]
    want = world["ref"]["jax_state"]
    assert got["step"] == 2 and got["count"] == 2
    adam = want.opt_state[1][0]
    for field, tree in (("params", want.params), ("mu", adam.mu),
                        ("nu", adam.nu)):
        flat = jax_flatten(tree)
        assert got[field].keys() == flat.keys(), field
        for k, v in flat.items():
            np.testing.assert_array_equal(got[field][k], np.asarray(v),
                                          err_msg=f"{field} {k}")


@pytest.mark.parametrize("key", ["serve_dp2", "serve_tp2"])
def test_service_over_a_mesh_answers_as_jax(world, key):
    got = world["ranks"][0][key]
    assert got["texts"] == world["ref"]["serve"]
    assert got["stats"]["requests"] == 3
    assert world["ranks"][1][key] is None  # the follower served no HTTP


def test_train_cli_tensor_parallel_matches_jax(world):
    got = world["ranks"][0]["train_tp2"]
    want = world["ref"]["train_tp2"]
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-5)
    assert got["final_per"] == pytest.approx(want["final_per"], abs=1e-9)
    assert world["ranks"][1]["train_tp2"]["final_loss"] == got["final_loss"]


def test_train_cli_chunked_over_the_world_matches_one_step_a_call(world):
    """DP=2 with --steps-per-call 4: each rank runs its local rows as one
    chunk of the run's 2 steps (one host: no fallback to 1), and the run
    equals the DP=2 --steps-per-call 1 run bit for bit (final loss,
    validation, checkpoint) on both ranks."""
    from whisper_ipa_torch.models.convert import load_safetensors_flat

    for rank in world["ranks"]:
        one, chunked = rank["train_dp2"], rank["train_dp2_spc4"]
        assert chunked["final_loss"] == one["final_loss"]
        assert chunked["final_per"] == one["final_per"]
    one, chunked = (world["ranks"][0][k]["dir"] for k in ("train_dp2",
                                                        "train_dp2_spc4"))
    a, b = (load_safetensors_flat(os.path.join(d, "checkpoint-2",
                                               "model.safetensors"))
            for d in (one, chunked))
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert "single-host only" not in world["logs"][0]


@pytest.mark.parametrize("key", list(TRAIN_FLAGS))
def test_train_cli_runs_over_the_world(world, key):
    got = world["ranks"][0][f"train_{key}"]
    out = got["dir"]
    assert np.isfinite(got["final_loss"])
    for name in ("model.safetensors", "opt_state.safetensors",
                 "training_state.json"):
        assert os.path.isfile(os.path.join(out, "checkpoint-2", name)), name
    assert os.path.isfile(os.path.join(out, "best-checkpoint", "model.safetensors"))
    log = world["logs"][0]
    if key == "zero1":
        assert "ZeRO-1: optimizer state sharded over data=2" in log
    if key == "fsdp":
        assert "FSDP (ZeRO-3): parameters AND optimizer state sharded" in log
    if key == "tp2":
        assert "Tensor parallel: Megatron param sharding over model=2" in log
