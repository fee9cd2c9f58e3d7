"""TrainState and the training step.

Counterpart of ``whisper_ipa_tpu/train/step.py`` (``TrainState``,
``create_train_state``, ``train_step``). The reference compiles one XLA
program per step and donates the state's buffers; here the step runs
eagerly: forward, ``torch.autograd.grad`` over the trainable tensors, then
the optimizer updates the parameters and moments in place (the returned
state is the same object, updated). Every float32 product in the step runs
at full fp32 on the card (``full_fp32``), as in the reference.

Over a mesh (``parallel.make_mesh``, one process a device) the step is
``make_zero1_step``'s: each rank feeds its rows of the global batch, and
the loss is the reference's global token-weighted mean (the sum of token
losses over the global count of valid tokens, which is all-reduced before
the forward; DDP's mean of per-rank means differs when the ranks' counts
do). Data-parallel gradients are summed in one coalesced all-reduce a
dtype. With ZeRO-1 the moments of each tensor are the rank's slice along
``zero1_spec``'s axis: the gradients are reduce-scattered there, AdamW
runs on the slice and the updated parameter is all-gathered. FSDP holds
the parameters as those slices too: ``models.whisper`` gathers a layer's
where it runs (and again in its recomputed backward), whose gradients
come back reduce-scattered. Megatron tensor parallelism (``mesh.tp``)
composes with each. Per-tensor clipping takes each whole tensor's norm:
the slices' sums of squares are all-reduced over 'data' (ZeRO-1, FSDP)
and over 'model' for TP-sharded tensors only.

Not ported: ``train_chunk`` (several steps per device call, ROADMAP item
[14]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import WhisperConfig
from ..models.convert import flatten_params, unflatten_params
from ..ops.precision import full_fp32
from ..parallel import distributed as D
from ..parallel.mesh import NamedSharding, P, global_shape, opt_state_shardings
from ..parallel.sharded import (
    FSDPBlock,
    all_gather_coalesced,
    all_reduce_coalesced,
    gather_slices,
    reduce_scatter_coalesced,
)
from .loss import compute_loss, eot_loss_mask
from .optimizer import Optimizer, OptState, Schedule

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ShardedLayout:
    """Where a sharded state's tensors live: the mesh, each parameter's
    NamedSharding (flat names) and ``opt_state_shardings``' OptState."""

    mesh: Any
    params: Dict[str, NamedSharding]
    opt: OptState


@dataclass
class TrainState:
    step: int
    params: Dict[str, Any]
    opt_state: OptState
    layout: Optional[ShardedLayout] = None  # set over a mesh


def create_train_state(
    params,
    learning_rate: float = 1e-5,
    max_grad_norm: float = 1.0,
    freeze_encoder: bool = True,
    schedule: Optional[Schedule] = None,
    accum_steps: int = 1,
    mu_dtype: Optional[str] = None,
) -> Tuple[TrainState, Optimizer]:
    """(state at step 0, the optimizer). ``schedule`` (a float or a
    function of the step count) replaces ``learning_rate`` when given;
    ``mu_dtype`` is None or "bfloat16"."""
    tx = Optimizer(
        learning_rate=schedule if schedule is not None else learning_rate,
        max_grad_norm=max_grad_norm,
        freeze_encoder=freeze_encoder,
        accum_steps=accum_steps,
        mu_dtype=_DTYPES[mu_dtype] if mu_dtype else None,
    )
    state = TrainState(
        step=0, params=params, opt_state=tx.init(flatten_params(params))
    )
    return state, tx


def train_step(
    state: TrainState,
    mel,
    tokens,
    cfg: WhisperConfig,
    tx: Optimizer,
    eot: int,
    freeze_encoder: bool = True,
    dtype_name: str = "float32",
    remat: bool = False,
    blockwise: bool = False,
    inputs_are_features: bool = False,
    bf16_head: bool = False,
) -> Tuple[TrainState, torch.Tensor]:
    """One optimization step. Returns (state, loss as a 0-d tensor on the
    device; read it with ``float()`` only when it is needed).

    dtype_name: activation dtype, "float32" or "bfloat16" (parameters,
    optimizer state and the logits head stay float32). inputs_are_features:
    ``mel`` holds precomputed encoder outputs (B, n_audio_ctx, d).
    """
    flat = flatten_params(state.params)
    names = [n for n in flat if tx.trainable(n)]
    leaves = [flat[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    try:
        with full_fp32():
            loss = compute_loss(
                state.params,
                cfg,
                None if inputs_are_features else mel,
                tokens,
                eot,
                audio_features=mel if inputs_are_features else None,
                freeze_encoder=freeze_encoder,
                dtype=_DTYPES[dtype_name],
                remat=remat,
                blockwise=blockwise,
                bf16_head=bf16_head,
            )
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = {
        n: torch.zeros_like(t) if g is None else g
        for n, t, g in zip(names, leaves, grads)
    }
    tx.step(flat, grads, state.opt_state)
    state.step += 1
    return state, loss.detach()


# -- over a mesh: DP, ZeRO-1, FSDP, each with or without TP -----------------


def _param_layout(mesh, params, tensor_parallel: bool):
    """Each parameter's NamedSharding, read from how it is placed: its TP
    spec (with ``tensor_parallel``), extended with 'data' (``zero1_spec``)
    where the tensor is an FSDP slice of its global shape."""
    from ..parallel.mesh import spec_for_param, zero1_spec

    out = {}
    for n, t in flatten_params(params).items():
        shape = global_shape(t)
        sh = NamedSharding(mesh, spec_for_param(n) if tensor_parallel else P())
        if sh.shard_shape(shape) != tuple(t.shape):
            sh = NamedSharding(mesh, zero1_spec(shape, mesh.shape["data"], sh.spec))
        if sh.shard_shape(shape) != tuple(t.shape):
            raise ValueError(
                f"{n}: a {tuple(t.shape)} block of {shape} is neither its "
                "TP block nor its FSDP slice"
            )
        out[n] = sh
    return out


def create_train_state_zero1(
    mesh,
    params,
    learning_rate: float = 1e-5,
    max_grad_norm: float = 1.0,
    freeze_encoder: bool = True,
    schedule: Optional[Schedule] = None,
    accum_steps: int = 1,
    mu_dtype: Optional[str] = None,
    tensor_parallel: bool = False,
) -> Tuple[TrainState, Optimizer, OptState]:
    """TrainState with ZeRO-1 sharded optimizer state.

    ``params`` are placed already (replicated, ``shard_params`` TP blocks
    or FSDP slices). The moments are created as each rank's slice (they
    never exist whole). Returns (state, tx, opt_shardings); drive steps
    with ``make_zero1_step(mesh, cfg, tx, eot, opt_shardings, ...)``.
    """
    tx = Optimizer(
        learning_rate=schedule if schedule is not None else learning_rate,
        max_grad_norm=max_grad_norm,
        freeze_encoder=freeze_encoder,
        accum_steps=accum_steps,
        mu_dtype=_DTYPES[mu_dtype] if mu_dtype else None,
    )
    opt_sh = opt_state_shardings(mesh, tx, params, tensor_parallel=tensor_parallel,
                                 zero1=True)
    state = TrainState(
        step=0, params=params, opt_state=_init_sharded_opt_state(tx, params, opt_sh),
        layout=ShardedLayout(mesh, _param_layout(mesh, params, tensor_parallel),
                             opt_sh),
    )
    return state, tx, opt_sh


def _init_sharded_opt_state(tx: Optimizer, params, opt_sh: OptState) -> OptState:
    """``tx.init`` with every moment at its sharding's local shape."""
    flat = flatten_params(params)

    def zeros(table, dtype=None):
        return {
            n: torch.zeros(sh.shard_shape(global_shape(flat[n])),
                           dtype=dtype or flat[n].dtype, device=flat[n].device)
            for n, sh in table.items()
        }

    return OptState(
        count=0,
        mu=zeros(opt_sh.mu, tx.mu_dtype),
        nu=zeros(opt_sh.nu),
        schedule_count=0 if tx.scheduled else None,
        acc_grads=zeros(opt_sh.acc_grads),
    )


def make_zero1_step(
    mesh,
    cfg: WhisperConfig,
    tx: Optimizer,
    eot: int,
    opt_shardings: OptState,
    param_shardings=None,
    chunk: bool = False,
    **knobs,
):
    """The step over a mesh: ``stepper(state, mel, tokens) -> (state,
    loss)`` on the rank's rows, the loss the global batch's.

    opt_shardings: ``opt_state_shardings``' (ZeRO-1 when they name 'data',
    plain DP otherwise). param_shardings: a tree of NamedShardings (TP
    specs, or ``fsdp_param_shardings``' for FSDP), None for replicated
    parameters. ``knobs`` are ``train_step``'s keyword flags.
    """
    if chunk:
        raise NotImplementedError(
            "chunk=True (train_chunk) is not ported (ROADMAP item [14])"
        )
    flags = dict(
        freeze_encoder=True, dtype_name="float32", remat=False,
        blockwise=False, inputs_are_features=False, bf16_head=False,
    )
    flags.update(knobs)

    def stepper(state, mel, tokens):
        p_sh = (flatten_params(param_shardings) if param_shardings is not None
                else _param_layout(mesh, state.params, False))
        state.layout = ShardedLayout(mesh, p_sh, opt_shardings)
        return _sharded_step(state, mel, tokens, cfg, tx, eot, **flags)

    return stepper


def _fsdp_forward_tree(params, axes: Dict[str, int], group):
    """The forward's view of FSDP slices: the tensors outside the layers
    gathered once, each layer an ``FSDPBlock`` that gathers its own."""
    flat = flatten_params(params)
    top = [n for n in axes if ".blocks." not in n]
    flat.update(zip(top, gather_slices([flat[n] for n in top],
                                       [axes[n] for n in top], group)))
    tree = unflatten_params(flat)
    for part in tree:
        blocks = tree[part].get("blocks", [])
        for i, block in enumerate(blocks):
            prefix = f"{part}.blocks.{i}."
            blocks[i] = FSDPBlock(
                block,
                {k[len(prefix):]: a for k, a in axes.items()
                 if k.startswith(prefix)},
                group,
            )
    return tree


def _sharded_step(state: TrainState, mel, tokens, cfg: WhisperConfig,
                  tx: Optimizer, eot: int, *, freeze_encoder: bool,
                  dtype_name: str, remat: bool, blockwise: bool,
                  inputs_are_features: bool, bf16_head: bool):
    layout = state.layout
    mesh = layout.mesh
    dgroup = mesh.data_group
    n_data = mesh.shape["data"]
    flat = flatten_params(state.params)
    names = [n for n in flat if tx.trainable(n)]
    fsdp_axis = {n: sh.axis("data") for n, sh in layout.params.items()
                 if sh.axis("data") is not None}
    zero_axis = {n: sh.axis("data") for n, sh in layout.opt.mu.items()
                 if sh.axis("data") is not None}
    for n, a in fsdp_axis.items():
        if n in zero_axis and zero_axis[n] != a:
            raise ValueError(
                f"{n}: FSDP splits axis {a} but its moments axis "
                f"{zero_axis[n]}; build both with the same tensor_parallel"
            )

    # the global count of valid tokens, before the forward
    n_local = eot_loss_mask(tokens[:, 1:], eot).sum().float().reshape(1)
    n_global = D.all_reduce(n_local.clone(), dgroup) if n_data > 1 else n_local
    scale = (n_local.clamp_min(1) / n_global.clamp_min(1))[0]

    leaves = [flat[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    try:
        with full_fp32():
            fwd = (_fsdp_forward_tree(state.params, fsdp_axis, dgroup)
                   if fsdp_axis else state.params)
            loss = compute_loss(
                fwd, cfg, None if inputs_are_features else mel, tokens, eot,
                audio_features=mel if inputs_are_features else None,
                freeze_encoder=freeze_encoder, dtype=_DTYPES[dtype_name],
                remat=remat, blockwise=blockwise, bf16_head=bf16_head,
                tp=mesh.tp if any(sh.axis("model") is not None
                                  for sh in layout.params.values()) else None,
            ) * scale
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = {
        n: torch.zeros_like(t) if g is None else g
        for n, t, g in zip(names, leaves, grads)
    }
    loss = loss.detach()

    with torch.no_grad():
        # FSDP slices' gradients came back reduce-scattered
        scatter = [n for n in names if n in zero_axis and n not in fsdp_axis]
        summed = [n for n in names if n not in zero_axis and n not in fsdp_axis]
        if n_data > 1:
            grads.update(zip(scatter, reduce_scatter_coalesced(
                [grads[n] for n in scatter], [zero_axis[n] for n in scatter],
                dgroup)))
            grads.update(zip(summed, all_reduce_coalesced(
                [grads[n] for n in summed], dgroup)))
            loss = D.all_reduce(loss.reshape(1).clone(), dgroup)[0]

        # the optimizer's view: the slice of each ZeRO-1 tensor
        views = {}
        for n in names:
            p = flat[n]
            if n in scatter:
                a = zero_axis[n]
                m = p.shape[a] // n_data
                p = p.narrow(a, mesh.data_rank * m, m)
            views[n] = p
        updated = tx.step(views, grads, state.opt_state,
                          reduce_sq=_sq_reducer(mesh, layout, zero_axis, fsdp_axis))
        if updated and scatter and n_data > 1:
            full = all_gather_coalesced([views[n] for n in scatter],
                                        [zero_axis[n] for n in scatter], dgroup)
            for n, f in zip(scatter, full):
                flat[n].copy_(f)
    state.step += 1
    return state, loss


def _sq_reducer(mesh, layout: ShardedLayout, zero_axis, fsdp_axis):
    """{name: local sum of squares} -> the whole tensor's: summed over
    'data' where the tensor is sliced there, over 'model' where TP splits
    it; a replicated tensor is counted once."""
    tp = mesh.tp

    def reduce(sq):
        classes: Dict[Tuple[bool, bool], list] = {}
        for n in sq:
            key = (mesh.shape["data"] > 1 and (n in zero_axis or n in fsdp_axis),
                   tp is not None and layout.params[n].axis("model") is not None)
            if any(key):
                classes.setdefault(key, []).append(n)
        out = dict(sq)
        for (over_data, over_model), group_names in classes.items():
            v = torch.stack([sq[n] for n in group_names])
            if over_data:
                D.all_reduce(v, mesh.data_group)
            if over_model:
                D.all_reduce(v, mesh.model_group)
            out.update(zip(group_names, v.unbind()))
        return out

    return reduce
