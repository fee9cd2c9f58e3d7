"""PyTorch port: chunked training (C optimizer steps a call) on the CPU.

- ``train.chunking``'s ``pow2_floor`` and ``stack_pad_batches`` against
  the JAX package's, the bf16 mel bits included (torch's cast against
  ``ml_dtypes``');
- ``train_chunk`` against the JAX package's ``train_chunk`` on the same
  bridged weights and stacked inputs, and against C port ``train_step``
  calls (bit for bit at equal widths; within 1e-6 where the chunk pads a
  narrower batch with EOT);
- the step body reads nothing from a tensor on the host (a
  ``TorchFunctionMode`` that records host reads and ``torch.tensor``
  copies);
- ``train(steps_per_call=4)`` against ``train(steps_per_call=1)``, and
  ``_chunk_len``'s boundaries;
- ``cli.train_medusa`` and ``cli.distill_draft`` with ``--steps-per-call
  2`` against 1;
- the switches ``use_decode_kernel`` / ``use_int4_matmul`` and the two
  kernel A/B CLIs' plain arms (a kernel arm without a card exits naming
  CUDA).
"""

import csv
import os
import re
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax.numpy as jnp

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.models import unflatten_params as jax_unflatten_params
from whisper_ipa_tpu.models.convert import save_safetensors as jax_save_safetensors
from whisper_ipa_tpu.train import chunking as jax_chunking
from whisper_ipa_tpu.train import create_train_state as jax_create_state
from whisper_ipa_tpu.train import train_chunk as jax_train_chunk
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.models import flatten_params, layers, params_from_numpy
from whisper_ipa_torch.train import (
    create_train_state,
    make_schedule,
    train,
    train_chunk,
    train_step,
)
from whisper_ipa_torch.train import chunking
from whisper_ipa_torch.train.loop import _chunk_len

from test_torch_data import write_dataset

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
EOT = 50257
LR = 1e-4
SOT = [50258, 50259, 50359, 50363]


@pytest.fixture(scope="module")
def flat_np():
    return {k: np.asarray(v) for k, v in
            jax_flatten_params(jax_init_params(JCFG, seed=0)).items()}


def _tokens(rng, width, lens):
    t = np.full((len(lens), width), EOT, np.int32)
    t[:, :4] = SOT
    for i, n in enumerate(lens):
        t[i, 4:4 + n] = rng.integers(0, 50000, n)
    return t


def _batches(widths, seed=0, B=2, frames=2 * CFG.n_audio_ctx):
    """Loader-like batches: seeded mels, SOT + random ids + EOT padding to
    each batch's width."""
    rng = np.random.default_rng(seed)
    return [dict(
        mel_features=rng.standard_normal((B, frames, CFG.n_mels)).astype(
            np.float32),
        tokens=_tokens(rng, w, rng.integers(1, w - 4, B)),
    ) for w in widths]


def _params(state):
    return {k: v.detach().clone() for k, v in flatten_params(state.params).items()}


# -- train.chunking ----------------------------------------------------------

def test_pow2_floor_matches_jax():
    got = [chunking.pow2_floor(n) for n in range(0, 71)]
    assert got == [jax_chunking.pow2_floor(n) for n in range(0, 71)]
    assert got[1:9] == [1, 2, 2, 4, 4, 4, 4, 8]


@pytest.mark.parametrize("bf16", [False, True])
def test_stack_pad_batches_matches_jax(bf16):
    batches = _batches([8, 12, 10], seed=1)
    mels, toks = chunking.stack_pad_batches(batches, EOT, bf16_mels=bf16)
    jmels, jtoks = jax_chunking.stack_pad_batches(batches, EOT, bf16_mels=bf16)
    assert toks.shape == (3, 2, 12) and toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    if bf16:
        assert mels.dtype == torch.bfloat16
        # round to nearest even in both: the same 16 bits
        np.testing.assert_array_equal(mels.view(torch.int16).numpy(),
                                      jmels.view(np.int16))
    else:
        np.testing.assert_array_equal(mels.numpy(), jmels)


# -- train_chunk -------------------------------------------------------------

@pytest.mark.parametrize("freeze", [True, False])
def test_train_chunk_matches_jax(flat_np, freeze):
    """C = 4 steps in one call from the same weights on the same stacked
    inputs: losses within 1e-5 relative, parameters within 1e-5."""
    mels, toks = chunking.stack_pad_batches(_batches([10] * 4, seed=2), EOT)
    jstate, jtx = jax_create_state(
        jax_unflatten_params({k: jnp.asarray(v) for k, v in flat_np.items()}),
        learning_rate=LR, freeze_encoder=freeze)
    jstate, jlosses = jax_train_chunk(
        jstate, jnp.asarray(mels.numpy()), jnp.asarray(toks.numpy()), JCFG,
        jtx, EOT, freeze_encoder=freeze)
    state, tx = create_train_state(params_from_numpy(flat_np),
                                   learning_rate=LR, freeze_encoder=freeze)
    state, losses = train_chunk(state, mels, toks.long(), CFG, tx, EOT,
                                freeze_encoder=freeze)
    assert losses.shape == (4,) and losses.dtype == torch.float32
    assert state.step == 4
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    ref = {k: np.asarray(v) for k, v in jax_flatten_params(jstate.params).items()}
    for k, v in _params(state).items():
        assert np.max(np.abs(v.numpy() - ref[k])) <= 1e-5, k


OPTS = {
    "plain": {},
    "accum2": dict(accum_steps=2),
    "warmup-linear-bf16": dict(
        schedule=make_schedule(LR, 2, "linear", total_steps=8),
        mu_dtype="bfloat16"),
}


def _state(flat_np, opt, freeze=False):
    return create_train_state(params_from_numpy(flat_np), learning_rate=LR,
                              freeze_encoder=freeze, **OPTS[opt])


@pytest.mark.parametrize("opt", list(OPTS))
def test_train_chunk_equals_sequential_steps(flat_np, opt):
    """At equal widths a chunk is its C steps, bit for bit: losses,
    parameters and both moments (gradient accumulation, a schedule and
    bf16 first moments included)."""
    mels, toks = chunking.stack_pad_batches(_batches([10] * 4, seed=3), EOT)
    toks = toks.long()
    state_a, tx_a = _state(flat_np, opt)
    seq = []
    for mel, tok in zip(mels, toks):
        state_a, loss = train_step(state_a, mel, tok, CFG, tx_a, EOT,
                                   freeze_encoder=False)
        seq.append(loss)
    state_b, tx_b = _state(flat_np, opt)
    state_b, losses = train_chunk(state_b, mels, toks, CFG, tx_b, EOT,
                                  freeze_encoder=False)
    assert torch.equal(losses, torch.stack(seq))
    a, b = _params(state_a), _params(state_b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for moment in ("mu", "nu"):
        ma, mb = getattr(state_a.opt_state, moment), getattr(state_b.opt_state, moment)
        assert all(torch.equal(ma[k], mb[k]) for k in ma), moment
    assert state_a.opt_state.count == state_b.opt_state.count


def test_mixed_width_chunk_within_bound_of_unpadded_steps(flat_np):
    """A chunk pads its narrower batches with EOT to the widest: the loss
    mask keeps the same tokens, so the steps agree with the unpadded ones
    up to the reductions' rounding (1e-6)."""
    batches = _batches([8, 12, 10, 12], seed=4)
    state_a, tx_a = _state(flat_np, "plain")
    seq = []
    for b in batches:
        state_a, loss = train_step(
            state_a, torch.from_numpy(b["mel_features"]),
            torch.from_numpy(b["tokens"]).long(), CFG, tx_a, EOT,
            freeze_encoder=False)
        seq.append(float(loss))
    mels, toks = chunking.stack_pad_batches(batches, EOT)
    state_b, tx_b = _state(flat_np, "plain")
    state_b, losses = train_chunk(state_b, mels, toks.long(), CFG, tx_b, EOT,
                                  freeze_encoder=False)
    np.testing.assert_allclose(losses.numpy(), seq, rtol=1e-6)
    a, b = _params(state_a), _params(state_b)
    for k in a:
        assert torch.max(torch.abs(a[k] - b[k])) <= 1e-6, k


class HostReads(TorchFunctionMode):
    """Records the calls that read a tensor's value on the host or copy a
    host value into a new tensor (on a card, each waits for the stream)."""

    WATCHED = {
        torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__,
        torch.Tensor.__float__, torch.Tensor.__int__, torch.Tensor.__index__,
        torch.Tensor.cpu, torch.Tensor.numpy, torch.Tensor.nonzero,
        torch.nonzero, torch.tensor, torch.as_tensor,
    }

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.WATCHED:
            self.seen.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("opt", list(OPTS))
def test_step_body_reads_nothing_on_the_host(flat_np, opt):
    """A chunk of full fine-tune steps calls nothing that reads the device
    from the host or copies a host value to it (the optimizer's scalars
    are fill kernels)."""
    mels, toks = chunking.stack_pad_batches(_batches([10] * 2, seed=5), EOT)
    state, tx = _state(flat_np, opt)
    with HostReads() as mode:
        train_chunk(state, mels, toks.long(), CFG, tx, EOT,
                    freeze_encoder=False)
    assert mode.seen == []


def test_host_reads_sees_a_host_copy():
    """The mode above records what it is there to catch."""
    with HostReads() as mode:
        x = torch.tensor(0.9, dtype=torch.float32)
        float(x.sum())
    assert mode.seen == ["tensor", "__float__"]


def test_optimizer_scalars_keep_their_bits():
    """The fill kernel rounds as the host copy did: bf16(0.9) =
    0.8984375, and the f32 constants and rates bit for bit."""
    from whisper_ipa_torch.train.optimizer import B1, B2, _scalar

    for v in (B1, B2, 1e-4, 3.3333333e-5):
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(_scalar(v, dt, "cpu"), torch.tensor(v, dtype=dt))
    assert _scalar(B1, torch.bfloat16, "cpu").item() == 0.8984375


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_shard_chunk_cuts_the_batch_axis_only(rank):
    """A rank's block of a global (C, B, ...) chunk holds its rows of
    every step: axis 1 cut over 'data', the chunk axis whole (the
    reference's P(None, 'data', ...)); without a mesh, the arrays."""
    from whisper_ipa_torch.parallel.mesh import shard_chunk

    rng = np.random.default_rng(7)
    mels = rng.standard_normal((4, 6, 8, 3)).astype(np.float32)
    toks = rng.integers(0, 9, (4, 6, 5))
    mesh = SimpleNamespace(shape={"data": 3, "model": 1},
                           device=torch.device("cpu"),
                           index=lambda axis: rank if axis == "data" else 0)
    m, t = shard_chunk(mesh, mels, toks)
    np.testing.assert_array_equal(m.numpy(), mels[:, 2 * rank:2 * rank + 2])
    np.testing.assert_array_equal(t.numpy(), toks[:, 2 * rank:2 * rank + 2])
    assert shard_chunk(None, mels) is mels


# -- train(steps_per_call=) --------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunk")
    data = write_dataset(str(root / "ds"), n=4, seconds=0.3)
    weights = str(root / "test-tiny.safetensors")
    jax_save_safetensors(weights, jax_init_params(JAX_CONFIGS["test-tiny"], seed=0))
    return data, weights


def _logged_steps(out):
    with open(os.path.join(out, "training_log.csv"), newline="") as f:
        return [int(r["step"]) for r in csv.DictReader(f)]


def test_train_steps_per_call_matches_sequential(inputs, tmp_path):
    """train(steps_per_call=4) against 1 (the reference's own test: 6
    steps, save_every=3): checkpoints 3 and 6 in both, the final loss and
    the parameters within 1e-6, the same logged steps."""
    from whisper_ipa_torch.models.convert import load_safetensors_flat

    data, weights = inputs
    outs = {}
    for spc in (1, 4):
        out = str(tmp_path / f"spc{spc}")
        summary = train(
            model_name="test-tiny", train_data_path=data, test_data_path=data,
            output_dir=out, num_steps=6, batch_size=2, learning_rate=1e-4,
            validate_every=0, save_every=3, final_validate=False, seed=11,
            weights=weights, steps_per_call=spc, device="cpu",
        )
        for n in (3, 6):
            assert os.path.isdir(os.path.join(out, f"checkpoint-{n}"))
        outs[spc] = (summary, out)
    (s1, o1), (s4, o4) = outs[1], outs[4]
    assert s4["final_loss"] == pytest.approx(s1["final_loss"], rel=1e-6)
    a = load_safetensors_flat(os.path.join(o1, "checkpoint-6", "model.safetensors"))
    b = load_safetensors_flat(os.path.join(o4, "checkpoint-6", "model.safetensors"))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=1e-6, err_msg=k)
    assert _logged_steps(o1) == _logged_steps(o4) == [1, 2, 3, 4, 5]


def test_train_resumes_mid_chunk(inputs, tmp_path):
    """Resume from checkpoint-3 with steps_per_call=4: the next chunks
    are 1 (to the save at 4), then 2 (to the end at 6)."""
    data, weights = inputs
    out = str(tmp_path / "run")
    kw = dict(model_name="test-tiny", train_data_path=data,
              test_data_path=data, output_dir=out, batch_size=2,
              learning_rate=1e-4, validate_every=0, final_validate=False,
              seed=11, weights=weights, steps_per_call=4, device="cpu")
    train(num_steps=3, save_every=3, **kw)
    summary = train(num_steps=6, save_every=4, resume=True, **kw)
    assert np.isfinite(summary["final_loss"])
    for n in (3, 4, 6):
        assert os.path.isdir(os.path.join(out, f"checkpoint-{n}"))
    assert _logged_steps(out) == [1, 2, 3, 4, 5]


def test_failed_chunk_checkpoints_the_steps_applied(inputs, tmp_path,
                                                    monkeypatch):
    """A step that raises inside a chunk (the second of 4) re-raises
    after the emergency checkpoint, labelled with the steps the state
    holds: checkpoint-1, whose metadata step and optimizer __step__ are 1
    and whose weights are a one-step run's (within 1e-6: the chunk pads
    its first batch to the chunk's widest)."""
    import json

    from safetensors.torch import load_file

    from whisper_ipa_torch.models.convert import load_safetensors_flat
    from whisper_ipa_torch.train import step as step_mod

    data, weights = inputs
    kw = dict(model_name="test-tiny", train_data_path=data,
              test_data_path=data, batch_size=2, learning_rate=1e-4,
              validate_every=0, final_validate=False, seed=11,
              weights=weights, device="cpu")
    ref = str(tmp_path / "ref")
    train(output_dir=ref, num_steps=1, save_every=1, steps_per_call=1, **kw)

    real, calls = step_mod.train_step, []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected step failure")
        return real(*a, **k)

    monkeypatch.setattr(step_mod, "train_step", failing)
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="injected step failure"):
        train(output_dir=out, num_steps=4, save_every=0, steps_per_call=4,
              **kw)
    assert sorted(d for d in os.listdir(out)
                  if d.startswith("checkpoint-")) == ["checkpoint-1"]
    ckpt = os.path.join(out, "checkpoint-1")
    with open(os.path.join(ckpt, "training_state.json")) as f:
        assert json.load(f)["step"] == 1
    assert int(load_file(os.path.join(ckpt, "opt_state.safetensors"))
               ["__step__"]) == 1
    a = load_safetensors_flat(os.path.join(ref, "checkpoint-1",
                                           "model.safetensors"))
    b = load_safetensors_flat(os.path.join(ckpt, "model.safetensors"))
    for k in a:
        np.testing.assert_allclose(np.asarray(b[k]), np.asarray(a[k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case,want", [
    ((0, 10, 4), 4),            # a whole chunk
    ((8, 10, 4), 2),            # the end of the run
    ((0, 6, 4, 0, 3), 2),       # a save at 3: 3 steps -> 2
    ((2, 6, 4, 0, 3), 1),
    ((0, 100, 8, 5, 0), 4),     # a validation at 5
    ((4, 100, 8, 5, 0), 1),
    ((0, 100, 16, 0, 0, 0), 8),   # the profiler's start mark at 9
    ((8, 100, 16, 0, 0, 0), 1),
    ((9, 100, 16, 0, 0, 0), 4),   # its stop mark at 15
    ((13, 100, 16, 0, 0, 0), 2),
    ((15, 100, 16, 0, 0, 0), 16),
    ((3, 100, 1, 0, 0, 0), 1),
])
def test_chunk_len_respects_boundaries(case, want):
    assert _chunk_len(*case) == want


@pytest.mark.parametrize("spc,validate,save,profile", [
    (8, 7, 10, None), (4, 0, 6, 0), (16, 25, 30, 5), (3, 0, 0, None),
])
def test_chunk_len_run_meets_every_mark(spc, validate, save, profile):
    """Over a whole run: powers of two of at most steps_per_call, summing
    to the run, ending on every validation and save, the profiler's window
    starting at a chunk's start and ending at a chunk's end."""
    num, step, ends = 61, profile or 0, []
    while step < num:
        n = _chunk_len(step, num, spc, validate, save, profile)
        assert n >= 1 and n & (n - 1) == 0 and n <= spc
        step += n
        ends.append(step)
    assert ends[-1] == num
    for period in (validate, save):
        if period:
            assert set(range(period, num + 1, period)) <= set(ends)
    if profile is not None:
        assert {profile + 9, profile + 15} <= set(ends)


# -- the Medusa and distillation trainers -------------------------------------

@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    import json

    from whisper_ipa_torch.audio import write_wav
    from whisper_ipa_torch.data.synth import synthesize_ipa

    root = tmp_path_factory.mktemp("synth")
    entries = []
    for i, ipa in enumerate(["ka", "tipu", "mo"]):
        path = str(root / f"b{i}.wav")
        write_wav(path, synthesize_ipa(ipa, seed=i))
        entries.append({"audio_path": path, "ipa_transcription": ipa})
    jp = str(root / "train.json")
    with open(jp, "w") as f:
        json.dump(entries, f, ensure_ascii=False)
    return jp


def test_train_medusa_steps_per_call_equivalent(synth_data, tmp_path, capsys):
    """--steps-per-call 2 draws the same batches and runs the same steps
    as 1 (bf16 mels, EOT-padded widths): the heads within 2e-6, as the
    reference's test holds them; the reference's log cadence."""
    from whisper_ipa_torch.cli.train_medusa import main as train_main
    from whisper_ipa_torch.models.medusa import load_medusa

    heads = {}
    for spc in (1, 2):
        out = str(tmp_path / f"heads{spc}.safetensors")
        train_main(["--model", "test-tiny", "--train-data", synth_data,
                    "--steps", "3", "--batch-size", "2", "--n-heads", "2",
                    "--output", out, "--log-every", "2", "--save-every", "0",
                    "--steps-per-call", str(spc), "--device", "cpu"])
        heads[spc] = load_medusa(out)
        logged = re.findall(r"step (\d+)/3: head loss", capsys.readouterr().out)
        # where a chunk crosses the cadence: step % log_every < n
        assert logged == (["1", "2"] if spc == 1 else ["2"])
    for h1, h2 in zip(heads[1]["heads"], heads[2]["heads"]):
        for k in h1:
            assert torch.max(torch.abs(h1[k] - h2[k])) <= 2e-6, k


def test_distill_draft_steps_per_call_equivalent(synth_data, tmp_path):
    """--steps-per-call 2 against 1 on fixed-width tokens: the same
    checkpoints, bit for bit, at the save (a chunk never crosses it) and
    the end."""
    from whisper_ipa_torch.cli import distill_draft
    from whisper_ipa_torch.models import init_params
    from whisper_ipa_torch.models.convert import load_safetensors_flat
    from whisper_ipa_torch.train import Optimizer, save_checkpoint
    from whisper_ipa_torch.train.step import TrainState

    teacher = init_params(CONFIGS["test-tiny"], seed=1)
    tx = Optimizer()
    ckpt = save_checkpoint(
        TrainState(step=0, params=teacher,
                   opt_state=tx.init(flatten_params(teacher))),
        0, None, str(tmp_path / "teacher"), save_opt_state=False)
    files = {}
    for spc in (1, 2):
        out = str(tmp_path / f"draft{spc}")
        distill_draft.main([
            "--student", "test-tiny", "--teacher", "test-tiny",
            "--teacher-checkpoint", ckpt, "--train-data", synth_data,
            "--output-dir", out, "--steps", "3", "--batch-size", "2",
            "--token-len", "16", "--save-every", "1", "--log-every", "1",
            "--steps-per-call", str(spc), "--device", "cpu"])
        files[spc] = {n: load_safetensors_flat(os.path.join(
            out, f"checkpoint-{n}", "model.safetensors")) for n in (1, 3)}
    for n in (1, 3):
        a, b = files[1][n], files[2][n]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"checkpoint-{n} {k}")


# -- the kernel switches and the A/B CLIs --------------------------------------

def _int8_cache(rng, B=2, H=2, Dh=8, T=128, int4=False):
    codes = lambda: torch.from_numpy(
        rng.integers(-127, 128, (B, H, Dh, T // 2 if int4 else T)).astype(np.int8))
    scales = lambda: torch.from_numpy(
        rng.uniform(0.001, 0.02, (B, H, T)).astype(np.float32))
    return codes(), scales(), codes(), scales()


@pytest.mark.parametrize("int4", [False, True])
def test_use_decode_kernel_switch(monkeypatch, int4):
    """True (the default) routes single-query steps to the K4 / K8
    wrapper, False to the plain version; the numbers are the same on the
    CPU, where the wrapper runs the plain version."""
    rng = np.random.default_rng(6)
    k, ks, v, vs = _int8_cache(rng, int4=int4)
    q = torch.from_numpy(rng.standard_normal((2, 1, 16)).astype(np.float32))
    name = ("decode_cross_attention_int4_tminor" if int4
            else "decode_cross_attention_int8_tminor")
    calls = []
    wrapper = getattr(layers, name)
    monkeypatch.setattr(layers, name,
                        lambda *a: calls.append(1) or wrapper(*a))
    outs = {"default": layers.multi_head_attention_int8kv(q, k, ks, v, vs, 2)}
    try:
        for flag in (False, True):
            layers.use_decode_kernel(flag)
            outs[flag] = layers.multi_head_attention_int8kv(q, k, ks, v, vs, 2)
    finally:
        layers.use_decode_kernel()
    assert len(calls) == 2 and layers._DECODE_KERNEL is True
    assert torch.equal(outs["default"], outs[False]) and torch.equal(outs[True], outs[False])


def test_use_int4_matmul_switch():
    """K7's eligibility on a CUDA-placed decode-shaped call: taken by
    default and under True, refused under False; never on the CPU."""
    p = {"w_q4": torch.zeros(64, 8, dtype=torch.int8),
         "w_s4": torch.zeros(1, 8)}
    on_card = SimpleNamespace(device=torch.device("cuda"), numel=lambda: 64)
    eligible = lambda: (layers._int4_matmul_eligible(on_card, p),
                        layers._int4_matmul_eligible(torch.zeros(1, 8), p))
    got = {"default": eligible()}
    try:
        for flag in (False, True):
            layers.use_int4_matmul(flag)
            got[flag] = eligible()
    finally:
        layers.use_int4_matmul()
    assert got == {"default": (True, False), True: (True, False),
                   False: (False, False)}


LINE = r"{} +\d+\.\d\d ms/token +\d+ GB/s effective +\(total \d+\.\d{{3}} s / 2 steps\)"


@pytest.mark.parametrize("int4", [False, True])
def test_bench_decode_kernel_plain_arm_on_cpu(capsys, int4):
    from whisper_ipa_torch.cli import bench_decode_kernel

    res = bench_decode_kernel.main(
        ["--batch", "2", "--heads", "2", "--head-dim", "8", "--t", "128",
         "--layers", "2", "--steps", "2", "--repeats", "1", "--device", "cpu"]
        + (["--int4"] if int4 else []))
    out = capsys.readouterr().out
    assert list(res) == ["plain"]
    assert re.search(LINE.format("plain"), out), out
    assert "wins" not in out


@pytest.mark.parametrize("cli,argv", [
    ("bench_decode_kernel", []),
    ("bench_decode_kernel", ["--int4"]),
    ("bench_quant_decode", []),
    ("bench_quant_decode", ["--device", "cpu", "--modes", "int4-kernel"]),
])
def test_kernel_arms_need_cuda(monkeypatch, cli, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"whisper_ipa_torch.cli.{cli}")
    with pytest.raises(SystemExit, match="CUDA"):
        mod.main(argv)


def test_bench_quant_decode_plain_modes_on_cpu(capsys):
    from whisper_ipa_torch.cli import bench_quant_decode

    res = bench_quant_decode.main(
        ["--model", "test-tiny", "--batch", "2", "--sample-len", "3",
         "--repeats", "1", "--modes", "f32,int8,int4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert list(res) == ["f32", "int8", "int4"]
    for mode in res:
        assert re.search(rf"{mode} +\d+\.\d ms/decode \( *\d+\.\d\d ms/token, "
                         r"first call \d+\.\d s\)", out), out
    assert layers._INT4_MATMUL is True
