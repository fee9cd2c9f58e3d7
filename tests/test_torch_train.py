"""PyTorch port: the fine-tuning slice against the JAX package on the CPU.

Loss and gradients, the optimizer against optax, the train-step
trajectory, and checkpoints that cross-restore between the two packages.
Parameters cross by the numpy bridge; inputs are made with numpy seeds.
Everything is float32 at test-tiny shapes.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.train import checkpoints as jax_ckpt
from whisper_ipa_tpu.train.loss import compute_loss as jax_compute_loss
from whisper_ipa_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from whisper_ipa_tpu.train.optimizer import make_schedule as jax_make_schedule
from whisper_ipa_tpu.train.step import create_train_state as jax_create_state
from whisper_ipa_tpu.train.step import train_step as jax_train_step
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.models import flatten_params, params_from_numpy
from whisper_ipa_torch.models import safetensors_io
from whisper_ipa_torch.train import (
    compute_loss,
    create_train_state,
    make_schedule,
    restore_checkpoint,
    save_checkpoint,
    train_step,
)
from whisper_ipa_torch.train.optimizer import Optimizer

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
EOT = 50257
LR = 1e-3
# the train-step trajectories: Adam normalizes each element, so float32
# noise in a near-zero gradient becomes an update difference of up to ~lr
# per step; the parameter bound of 1e-5 after 5 steps holds at 1e-4 (ten
# times the CLI's default rate)
STEP_LR = 1e-4


@pytest.fixture(scope="module")
def flat_np():
    """Seed-0 JAX init as {canonical name: array} (the shared weights)."""
    return {
        k: np.asarray(v)
        for k, v in jax_flatten_params(jax_init_params(JCFG, seed=0)).items()
    }


def jax_tree(flat_np):
    from whisper_ipa_tpu.models import unflatten_params

    return unflatten_params({k: jnp.asarray(v) for k, v in flat_np.items()})


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 2 * CFG.n_audio_ctx, CFG.n_mels)).astype(
        np.float32
    )
    tokens = np.full((2, 10), EOT, np.int32)
    tokens[:, :4] = [50258, 50259, 50359, 50363]
    tokens[0, 4:7] = [10, 20, 30]
    tokens[1, 4:9] = [5, 6, 7, 8, 9]
    return mel, tokens


def _max_rel(a, b):
    b = np.asarray(b)
    return float(np.max(np.abs(np.asarray(a) - b)) / (np.max(np.abs(b)) + 1e-30))


# -- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("bf16_head", [False, True])
@pytest.mark.parametrize("blockwise", [False, True])
@pytest.mark.parametrize("freeze", [True, False])
def test_loss_and_grads_match_jax(flat_np, batch, freeze, blockwise, bf16_head):
    """Loss relative 1e-6; every trainable gradient within 1e-5 of its own
    max |grad| (float32, summation order differs between the frameworks)."""
    mel, tokens = batch
    kw = dict(freeze_encoder=freeze, blockwise=blockwise, bf16_head=bf16_head)
    jl, jg = jax.value_and_grad(
        lambda p: jax_compute_loss(
            p, JCFG, jnp.asarray(mel), jnp.asarray(tokens), EOT, **kw
        )
    )(jax_tree(flat_np))
    jg = {k: np.asarray(v) for k, v in jax_flatten_params(jg).items()}

    params = params_from_numpy(flat_np)
    flat = flatten_params(params)
    names = [n for n in flat if not (freeze and n.startswith("encoder."))]
    for n in names:
        flat[n].requires_grad_(True)
    loss = compute_loss(
        params, CFG, torch.from_numpy(mel), torch.from_numpy(tokens).long(),
        EOT, **kw,
    )
    grads = torch.autograd.grad(loss, [flat[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    if freeze:
        assert not any(n.startswith("encoder.") for n in names)
        assert all(np.all(jg[n] == 0) for n in jg if n.startswith("encoder."))
    for n, g in zip(names, grads):
        assert _max_rel(g.numpy(), jg[n]) < 1e-5, n


# -- optimizer ------------------------------------------------------------------

def _grads(flat_np, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        k: (rng.standard_normal(v.shape) * scale * (1 + (i % 3))).astype(np.float32)
        for i, (k, v) in enumerate(flat_np.items())
    }


def _run_optax(flat_np, grads_seq, freeze, **kw):
    from whisper_ipa_tpu.models import unflatten_params

    params = jax_tree(flat_np)
    tx = jax_make_optimizer(learning_rate=kw.pop("lr", LR),
                            freeze_encoder=freeze, **kw)
    opt_state = tx.init(params)
    for g in grads_seq:
        gt = unflatten_params({k: jnp.asarray(v) for k, v in g.items()})
        updates, opt_state = tx.update(gt, opt_state, params)
        params = optax.apply_updates(params, updates)
    return (
        {k: np.asarray(v) for k, v in jax_flatten_params(params).items()},
        opt_state,
    )


def _run_port(flat_np, grads_seq, freeze, **kw):
    mu_dtype = kw.pop("mu_dtype", None)
    params = params_from_numpy(flat_np)
    flat = flatten_params(params)
    tx = Optimizer(
        learning_rate=kw.pop("lr", LR), freeze_encoder=freeze,
        mu_dtype=torch.bfloat16 if mu_dtype else None, **kw,
    )
    state = tx.init(flat)
    for g in grads_seq:
        tx.step(flat, {n: torch.from_numpy(g[n]) for n in state.nu}, state)
    return {k: v.numpy() for k, v in flat.items()}, state


def _adam_state(opt_state):
    """The ScaleByAdamState inside the reference's optax state."""
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)
    )
    return next(x for x in leaves if isinstance(x, optax.ScaleByAdamState))


@pytest.mark.parametrize("freeze", [True, False])
def test_adamw_matches_optax(flat_np, freeze):
    """Three updates on the same clipped gradients (scale 3: every tensor's
    norm exceeds 1): parameters within 1e-6 absolute, moments within 1e-6
    of their scale; a frozen encoder is untouched and has no state."""
    seq = [_grads(flat_np, 1, scale=3.0)] * 3
    ref, ref_state = _run_optax(flat_np, seq, freeze)
    ours, state = _run_port(flat_np, seq, freeze)
    for k in ref:
        assert np.max(np.abs(ours[k] - ref[k])) <= 1e-6, k
        if freeze and k.startswith("encoder."):
            assert np.array_equal(ours[k], flat_np[k])
            assert k not in state.mu
    adam = _adam_state(ref_state)
    assert state.count == int(adam.count) == 3
    mu = {k: np.asarray(v) for k, v in jax_flatten_params(adam.mu).items()}
    for k, v in state.mu.items():
        assert _max_rel(v.numpy(), mu[k]) <= 1e-6, k


@pytest.mark.parametrize(
    "warmup,decay", [(0, "constant"), (5, "constant"), (5, "linear"),
                     (0, "linear"), (0, "cosine"), (5, "cosine")],
)
def test_schedules_match_optax(warmup, decay):
    """Every step of a 20-step run, relative 1e-6 (both in float32)."""
    ref = jax_make_schedule(3e-4, warmup, decay, total_steps=20)
    ours = make_schedule(3e-4, warmup, decay, total_steps=20)
    for step in range(21):
        want = float(ref(step)) if callable(ref) else ref
        got = ours(step) if callable(ours) else ours
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_accumulation_and_schedule_match_optax(flat_np):
    """accum_steps=2 (Welford mean, one update per 2 calls) and a warmup +
    linear-decay schedule over 4 calls with distinct gradients: parameters
    within 1e-6 absolute."""
    seq = [_grads(flat_np, s) for s in range(4)]
    sched = jax_make_schedule(LR, 1, "linear", total_steps=4)
    ref, _ = _run_optax(flat_np, seq, True, schedule=sched, accum_steps=2)
    ours, state = _run_port(
        flat_np, seq, True, accum_steps=2,
        lr=make_schedule(LR, 1, "linear", total_steps=4),
    )
    assert state.count == 2 and state.gradient_step == 2
    assert state.schedule_count == 2 and state.mini_step == 0
    for k in ref:
        assert np.max(np.abs(ours[k] - ref[k])) <= 1e-6, k


def test_bf16_first_moment_matches_optax(flat_np):
    """mu_dtype="bfloat16" over 3 updates. The clip coefficient's norm is
    summed in another order, so a float32 first moment may differ by an
    ulp, which now and then flips its bfloat16 rounding (and the next
    update carries that step on): fewer than 1% of the moments differ, by
    at most one bfloat16 step at the tensor's scale (2^-7 of its max);
    parameters within n_updates * lr * 2^-7."""
    seq = [_grads(flat_np, s) for s in range(3)]
    ref, ref_state = _run_optax(flat_np, seq, True, mu_dtype="bfloat16")
    ours, state = _run_port(flat_np, seq, True, mu_dtype="bfloat16")
    mu = {
        k: np.asarray(v.astype(jnp.float32))
        for k, v in jax_flatten_params(_adam_state(ref_state).mu).items()
        if not isinstance(v, optax.MaskedNode)
    }
    for k, v in state.mu.items():
        assert v.dtype == torch.bfloat16
        diff = np.abs(v.float().numpy() - mu[k])
        assert diff.max() <= 2.0 ** -7 * np.abs(mu[k]).max(), k
        assert np.mean(diff > 0) < 0.01, k
    for k in ref:
        assert np.max(np.abs(ours[k] - ref[k])) <= 3 * LR * 2.0 ** -7, k


# -- the train step -----------------------------------------------------------

# optimizer settings of the cross-restore tests: gradient accumulation, a
# warmup + linear-decay schedule with bfloat16 first moments, and both
OPTS = {
    "plain": {},
    "accum2": dict(accum_steps=2),
    "warmup-linear-bf16": dict(warmup=3, decay="linear", mu_dtype="bfloat16"),
    "accum2-warmup-linear-bf16": dict(accum_steps=2, warmup=3, decay="linear",
                                      mu_dtype="bfloat16"),
}


def _state_kw(opt, make):
    """create_train_state's keywords for OPTS[opt], the schedule made by
    ``make`` (the package's make_schedule)."""
    kw = dict(OPTS[opt])
    if "decay" in kw:
        kw["schedule"] = make(STEP_LR, kw.pop("warmup"), kw.pop("decay"),
                              total_steps=10)
    return kw


def _jax_create(flat_np, freeze, opt="plain"):
    return jax_create_state(
        jax_tree(flat_np), learning_rate=STEP_LR, freeze_encoder=freeze,
        **_state_kw(opt, jax_make_schedule),
    )


def _jax_steps(state, tx, batch, freeze, n):
    mel, tokens = batch
    losses = []
    for _ in range(n):
        state, loss = jax_train_step(
            state, jnp.asarray(mel), jnp.asarray(tokens), JCFG, tx, EOT,
            freeze_encoder=freeze,
        )
        losses.append(float(loss))
    return losses, state


def _jax_trajectory(flat_np, batch, freeze, n, opt="plain"):
    state, tx = _jax_create(flat_np, freeze, opt)
    return _jax_steps(state, tx, batch, freeze, n)


def _port_state(flat_np, freeze, opt="plain"):
    return create_train_state(
        params_from_numpy(flat_np), learning_rate=STEP_LR,
        freeze_encoder=freeze, **_state_kw(opt, make_schedule),
    )


def _port_steps(state, tx, batch, freeze, n):
    mel, tokens = (torch.from_numpy(a) for a in batch)
    losses = []
    for _ in range(n):
        state, loss = train_step(
            state, mel, tokens.long(), CFG, tx, EOT, freeze_encoder=freeze
        )
        losses.append(float(loss))
    return losses, state


@pytest.mark.parametrize("freeze", [True, False])
def test_train_step_trajectory_matches_jax(flat_np, batch, freeze):
    """Five steps from the same parameters on the same batch: losses within
    1e-5 relative, final parameters within 1e-5 absolute. A frozen encoder
    is bitwise unchanged; an unfrozen one moves."""
    ref_losses, ref_state = _jax_trajectory(flat_np, batch, freeze, 5)
    state, tx = _port_state(flat_np, freeze)
    losses, state = _port_steps(state, tx, batch, freeze, 5)
    assert state.step == 5
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    ref = {k: np.asarray(v) for k, v in jax_flatten_params(ref_state.params).items()}
    ours = {k: v.numpy() for k, v in flatten_params(state.params).items()}
    for k in ref:
        assert np.max(np.abs(ours[k] - ref[k])) <= 1e-5, k
    enc = [k for k in ours if k.startswith("encoder.")]
    if freeze:
        assert all(np.array_equal(ours[k], flat_np[k]) for k in enc)
    else:
        assert any(not np.array_equal(ours[k], flat_np[k]) for k in enc)


# -- checkpoints ----------------------------------------------------------------

def test_safetensors_files_cross_read(tmp_path):
    """The in-tree writer's file reads back through the safetensors
    package bit for bit (bf16 included), and is byte-identical to the
    package's own file; the package's file reads back in-tree."""
    import ml_dtypes
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    arrays = {
        "b.w": rng.standard_normal((3, 5)).astype(np.float32),
        "a.count": np.asarray(7, np.int32),
        "z.mu": rng.standard_normal(6).astype(ml_dtypes.bfloat16),
        "c.i64": np.arange(4, dtype=np.int64),
    }
    ours = str(tmp_path / "ours.safetensors")
    theirs = str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(
        {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
             if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
         for k, v in arrays.items()},
        ours,
    )
    save_file(arrays, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = load_file(ours)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert back[k].tobytes() == v.tobytes()
    mine = safetensors_io.load_file(theirs)
    assert mine["z.mu"].dtype == torch.bfloat16
    assert np.array_equal(
        mine["z.mu"].view(torch.int16).numpy(), arrays["z.mu"].view(np.int16)
    )
    assert int(mine["a.count"]) == 7 and mine["a.count"].shape == ()


def _compare_states(port_state, jax_state, freeze):
    """Params, AdamW moments, step and counts equal between the two
    packages; with gradient accumulation also the mini step, the gradient
    step and the accumulated gradients."""
    assert port_state.step == int(jax_state.step)
    ref = {k: np.asarray(v) for k, v in jax_flatten_params(jax_state.params).items()}
    ours = {k: v.numpy() for k, v in flatten_params(port_state.params).items()}
    assert ref.keys() == ours.keys()
    for k in ref:
        assert np.array_equal(ours[k], ref[k]), k
    opt = port_state.opt_state
    adam = _adam_state(jax_state.opt_state)
    assert int(adam.count) == opt.count
    for field in ("mu", "nu"):
        ref_m = {
            k: np.asarray(v.astype(jnp.float32))
            for k, v in jax_flatten_params(getattr(adam, field)).items()
            if not isinstance(v, optax.MaskedNode)
        }
        ours_m = {k: v.float().numpy() for k, v in getattr(opt, field).items()}
        assert ours_m.keys() == {
            k for k in ref_m if not (freeze and k.startswith("encoder."))
        }
        for k in ours_m:
            assert np.array_equal(ours_m[k], ref_m[k]), (field, k)
    counts = [x.count for x in jax.tree_util.tree_leaves(
        jax_state.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
        if isinstance(x, optax.ScaleByScheduleState)]
    assert opt.schedule_count == (int(counts[0]) if counts else None)
    multi = jax_state.opt_state
    if isinstance(multi, optax.MultiStepsState):
        assert (opt.mini_step, opt.gradient_step) == (
            int(multi.mini_step), int(multi.gradient_step))
        acc = {k: np.asarray(v)
               for k, v in jax_flatten_params(multi.acc_grads).items()}
        assert opt.acc_grads and set(opt.acc_grads) <= acc.keys()
        for k, v in acc.items():
            want = opt.acc_grads[k].numpy() if k in opt.acc_grads else 0.0
            assert np.array_equal(v, np.broadcast_to(want, v.shape)), k
    else:
        assert (opt.mini_step, opt.gradient_step, opt.acc_grads) == (0, 0, {})


# (freeze, optimizer setting): both layouts at a constant rate, then the
# other settings with the frozen encoder
RESTORE_CASES = [
    pytest.param(True, "plain", id="True"),
    pytest.param(False, "plain", id="False"),
    pytest.param(True, "accum2", id="accum2"),
    pytest.param(True, "warmup-linear-bf16", id="warmup-linear-bf16"),
    pytest.param(True, "accum2-warmup-linear-bf16",
                 id="accum2-warmup-linear-bf16"),
]


def _saved_accumulation(ckpt, opt):
    """The opt_state file carries the accumulation state when it should
    (every accumulated gradient under .acc_grads)."""
    keys = safetensors_io.load_file(
        os.path.join(ckpt, "opt_state.safetensors")).keys()
    accum = OPTS[opt].get("accum_steps", 1) > 1
    for key in (".mini_step", ".gradient_step"):
        assert (key in keys) == accum
    assert any(k.startswith(".acc_grads[") for k in keys) == accum


def _after_restore_agree(port, jax_, losses, ref_losses):
    """Two more steps on each side: losses relative 1e-5, parameters within
    1e-5 absolute."""
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    ref = {k: np.asarray(v) for k, v in jax_flatten_params(jax_.params).items()}
    for k, v in flatten_params(port.params).items():
        assert np.max(np.abs(v.numpy() - ref[k])) <= 1e-5, k


@pytest.mark.parametrize("freeze,opt", RESTORE_CASES)
def test_port_checkpoint_restores_in_jax(flat_np, batch, freeze, opt, tmp_path):
    """A port checkpoint (mid-accumulation where accumulating) restores in
    JAX with equal state and counts; two more steps on each side agree."""
    n = 2 if opt == "plain" else 3  # 3: one gradient waits in acc_grads
    state, tx = _port_state(flat_np, freeze, opt)
    _, state = _port_steps(state, tx, batch, freeze, n)
    ckpt = save_checkpoint(state, n, 1.0, str(tmp_path))
    _saved_accumulation(ckpt, opt)
    template, jtx = _jax_create(flat_np, freeze, opt)
    restored, meta = jax_ckpt.restore_checkpoint(ckpt, template)
    assert meta["step"] == n
    _compare_states(state, restored, freeze)
    ref_losses, restored = _jax_steps(restored, jtx, batch, freeze, 2)
    losses, state = _port_steps(state, tx, batch, freeze, 2)
    _after_restore_agree(state, restored, losses, ref_losses)


@pytest.mark.parametrize("freeze,opt", RESTORE_CASES)
def test_jax_checkpoint_restores_in_port(flat_np, batch, freeze, opt, tmp_path):
    """A JAX checkpoint resumes in the port: equal state and counts, and
    the port's next two steps give the JAX run's losses (relative 1e-5)
    and parameters (within 1e-5)."""
    n = 2 if opt == "plain" else 3
    jstate, jtx = _jax_create(flat_np, freeze, opt)
    _, jstate = _jax_steps(jstate, jtx, batch, freeze, n)
    ckpt = jax_ckpt.save_checkpoint(jstate, n, 1.0, str(tmp_path))
    _saved_accumulation(ckpt, opt)
    template, tx = _port_state(flat_np, freeze, opt)
    restored, _ = restore_checkpoint(ckpt, template)
    _compare_states(restored, jstate, freeze)
    ref_losses, jstate = _jax_steps(jstate, jtx, batch, freeze, 2)
    losses, restored = _port_steps(restored, tx, batch, freeze, 2)
    _after_restore_agree(restored, jstate, losses, ref_losses)


def test_resumed_run_continues_the_same_trajectory(flat_np, batch, tmp_path):
    """Save after 2 steps, restore into a fresh state: the third step's
    loss equals the uninterrupted run's (the state round trip is exact)."""
    state, tx = _port_state(flat_np, True)
    full, _ = _port_steps(state, tx, batch, True, 3)
    state, tx = _port_state(flat_np, True)
    _, state = _port_steps(state, tx, batch, True, 2)
    ckpt = save_checkpoint(state, 2, 1.0, str(tmp_path))
    fresh, tx = _port_state(flat_np, True)
    restored, _ = restore_checkpoint(ckpt, fresh)
    assert restored.step == 2
    resumed, _ = _port_steps(restored, tx, batch, True, 1)
    assert resumed[0] == full[2]


def test_restore_refuses_another_layout(flat_np, batch, tmp_path):
    """A frozen-encoder optimizer file does not silently load into an
    unfrozen run."""
    state, tx = _port_state(flat_np, True)
    ckpt = save_checkpoint(state, 0, None, str(tmp_path))
    other, _ = _port_state(flat_np, False)
    with pytest.raises(ValueError, match="layout"):
        restore_checkpoint(ckpt, other)
    assert os.path.isfile(os.path.join(ckpt, "opt_state.safetensors"))
