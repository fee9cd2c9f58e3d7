"""Process-group initialization, collectives and host-local data sharding.

Counterpart of ``whisper_ipa_tpu/parallel/distributed.py``. The reference
is single-controller: one process sees every device and ``jax.distributed``
joins the hosts. The port follows PyTorch's idiom instead, one process a
device (SPMD over ranks, as torchrun launches them), so ``initialize``
joins a ``torch.distributed`` process group and the collectives are
explicit calls on the groups of a ``make_mesh`` mesh.

The backend follows the rank's device: NCCL for ``cuda``, gloo for
``cpu``. A caller that wants gloo with CUDA tensors (several ranks sharing
one card) names it with ``backend="gloo"``; the helpers below then stage
every collective on a CUDA tensor through host memory, since gloo's CUDA
support differs between versions (``STAGED`` records which ones ran so).
Nothing falls back by itself: a failed init raises.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the rank's device, set by initialize(); "cuda" when nothing set it
_DEVICE: List[Optional[torch.device]] = [None]

# names of the collectives that ran staged through host memory (gloo with
# CUDA tensors)
STAGED: set = set()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
) -> None:
    """Join the process group (no-op for one process, as the reference).

    Absent arguments come from torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``.
    ``device`` is the rank's device; a bare "cuda" becomes card
    ``LOCAL_RANK % device_count``. ``backend`` defaults to NCCL for a
    CUDA device and gloo for the CPU; naming one also builds a group at
    world 1 (a one-rank NCCL group checks the backend on a single card).
    """
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is false; pass "
                "device='cpu' to run the ranks on the CPU"
            )
        if dev.index is None:
            local = int(env.get("LOCAL_RANK", 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    _DEVICE[0] = dev
    world = num_processes or 1
    if world <= 1 and backend is None:
        return
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if coordinator_address is None:
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError(
                "no coordinator: pass coordinator_address or set "
                "MASTER_ADDR and MASTER_PORT (torchrun sets them)"
            )
        coordinator_address = f"{addr}:{port}"
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=world,
        rank=process_id or 0,
    )


def default_device() -> torch.device:
    """The device ``initialize`` chose for this rank ("cuda" before it)."""
    return _DEVICE[0] if _DEVICE[0] is not None else torch.device("cuda")


def _rank_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_info() -> dict:
    """The reference's four keys; one device a process."""
    rank, world = _rank_world()
    return {
        "process_index": rank,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


def local_shard_indices(n_items: int, index: Optional[int] = None,
                        count: Optional[int] = None) -> Sequence[int]:
    """Dataset indices owned by this process (contiguous block partition).

    index/count default to the process rank and the world size; the
    training loop passes the data-parallel index and degree, so the ranks
    of one tensor-parallel group read the same rows."""
    rank, world = _rank_world()
    p = rank if index is None else index
    n = world if count is None else count
    per = (n_items + n - 1) // n
    return list(range(p * per, min((p + 1) * per, n_items)))


def global_batch_from_local(mesh, local_batch):
    """This rank's rows of the global batch, on its device.

    In the SPMD model the global batch is the union of the ranks' local
    rows (local rows x the data degree); nothing is copied between ranks.
    """
    device = mesh.device if mesh is not None else default_device()
    return torch.as_tensor(np.asarray(local_batch)).to(device)


# -- collectives ------------------------------------------------------------


def _staged(name: str, t: torch.Tensor, group) -> bool:
    """True when ``t`` is a CUDA tensor on a gloo group: the caller chose
    gloo, so the collective runs on a host copy."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        STAGED.add(name)
        return True
    return False


def _bits(host: torch.Tensor) -> torch.Tensor:
    """A half-precision host tensor as int16, for collectives that only
    move bytes (gloo's half support differs between versions)."""
    if host.dtype in (torch.float16, torch.bfloat16):
        return host.view(torch.int16)
    return host


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group in place; returns it. A staged half-
    precision tensor is summed in float32 on the host and rounded once."""
    if _staged("all_reduce", t, group):
        host = t.cpu()
        if host.dtype in (torch.float16, torch.bfloat16):
            host = host.float()
        dist.all_reduce(host, group=group)
        t.copy_(host)
        return t
    dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s values; returns it."""
    if _staged("broadcast", t, group):
        host = _bits(t.cpu())
        dist.broadcast(host, src=src, group=group)
        t.copy_(host.view(t.dtype))
        return t
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors joined along ``dim`` in group-rank order."""
    n = group_size(group)
    x = t.movedim(dim, 0).contiguous()
    staged = _staged("all_gather", x, group)
    src = _bits(x.cpu()) if staged else x
    if dist.get_backend(group) == "nccl":
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
    else:
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
    if staged:
        out = out.view(t.dtype).to(t.device)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Sum over the group, keeping this rank's block of ``dim``.

    NCCL runs a reduce-scatter (``reduce_scatter_single`` where the torch
    version has it, else ``reduce_scatter_tensor``); gloo sums with an
    all-reduce and keeps the block, which is the same result."""
    n = group_size(group)
    r = group_rank(group)
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} ways")
    m = x.shape[0] // n
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((m,) + tuple(x.shape[1:]))
        fn = getattr(dist, "reduce_scatter_single", None)
        if fn is None:
            fn = dist.reduce_scatter_tensor
        fn(out, x, group=group)
    else:
        out = all_reduce(x.clone(), group).narrow(0, r * m, m)
    return out.movedim(0, dim)


def all_gather_object(obj, group=None) -> list:
    """Every rank's ``obj``, in group-rank order (pickled over the group)."""
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
