"""The (data, model) mesh and the sharding rules, over ``torch.distributed``.

Counterpart of ``whisper_ipa_tpu/parallel/mesh.py``, with its names and
rules. The reference places global arrays with ``NamedSharding``s and
GSPMD inserts the collectives; here each rank is one process holding its
local shard as a plain tensor, and ``NamedSharding`` is a small spec
object that says which axis is split over 'data' and/or 'model' and cuts
a rank's block. A shard's shape equals the reference's for every tensor.

* ``make_mesh`` builds a ``torch.distributed.device_mesh`` over the world
  with dims ("data", "model"), rank r at data index r // model and model
  index r % model (the reference's ``reshape(data, model)``); its groups
  carry the collectives.
* A batch is sharded by rows over 'data': ``shard_batch`` keeps a rank's
  block of a global batch every rank holds; ``shard_padded_batch`` pads
  it to a multiple of 'data' first.
* ``shard_params`` keeps each rank's block of every TP-ruled tensor; the
  sharded tensors remember their global shape (``global_shape``), so the
  rules below apply to them as to the unsharded tree.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as D
from .sharded import TensorParallel


class PartitionSpec(tuple):
    """Per-axis mesh axis names (None: not split), as JAX's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

_GLOBAL_SHAPE = "_wipa_global_shape"


def global_shape(t) -> Tuple[int, ...]:
    """The unsharded shape of a (possibly sharded) parameter tensor."""
    return tuple(getattr(t, _GLOBAL_SHAPE, None) or t.shape)


def _mark(t: torch.Tensor, shape) -> torch.Tensor:
    setattr(t, _GLOBAL_SHAPE, tuple(shape))
    return t


class Mesh:
    """This rank's view of a (data, model) device mesh."""

    def __init__(self, data: int, model: int, device: torch.device):
        from torch.distributed.device_mesh import init_device_mesh

        backend = dist.get_backend()
        self.device = device
        self.device_mesh = init_device_mesh(
            "cuda" if backend == "nccl" else "cpu", (data, model),
            mesh_dim_names=("data", "model"),
        )
        self.shape = {"data": data, "model": model}
        self.data_group = self.device_mesh.get_group("data")
        self.model_group = self.device_mesh.get_group("model")
        rank = dist.get_rank()
        self.data_rank, self.model_rank = rank // model, rank % model

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def tp(self) -> Optional[TensorParallel]:
        """The tensor-parallel handle the model functions take, or None."""
        if self.shape["model"] == 1:
            return None
        return TensorParallel(self.model_group, self.shape["model"],
                              self.model_rank)

    def group(self, axis: str):
        return self.data_group if axis == "data" else self.model_group

    def index(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']},"
                f" device={self.device})")


class NamedSharding:
    """A mesh and a PartitionSpec: which axis each mesh axis splits."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    def axis(self, name: str) -> Optional[int]:
        for i, e in enumerate(self.spec):
            if e == name:
                return i
        return None

    def shard_shape(self, shape) -> Tuple[int, ...]:
        out = list(shape)
        for i, e in enumerate(self.spec):
            if e is not None:
                out[i] //= self.mesh.shape[e]
        return tuple(out)

    def local_block(self, t: torch.Tensor, axes=("data", "model")):
        """This rank's block of a global tensor along the named axes."""
        for name in axes:
            i = self.axis(name)
            if i is not None:
                m = t.shape[i] // self.mesh.shape[name]
                t = t.narrow(i, self.mesh.index(name) * m, m)
        return t

    def gather(self, t: torch.Tensor, axes=("data", "model")) -> torch.Tensor:
        """The global tensor from this rank's block (collective)."""
        for name in reversed(axes):
            i = self.axis(name)
            if i is not None:
                t = D.all_gather(t, self.mesh.group(name), dim=i)
        return t

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Optional[Mesh]:
    """Build a (data, model) mesh over the processes of the world.

    devices: one device a rank (default: the rank's device, for every
    rank). data defaults to n_devices // model. Returns None when there
    is one device and no model parallelism (plain single-device
    execution). One process runs a device, so data x model must be the
    world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = (list(devices) if devices is not None
               else [D.default_device()] * world)
    n = len(devices)
    if model < 1 or n % model != 0:
        raise ValueError(f"model={model} does not divide {n} devices")
    if data is None:
        data = n // model
    if data * model == 1:
        return None
    if data * model != world or n != world:
        raise ValueError(
            f"data={data} x model={model} must equal the world size "
            f"({world} processes, one device each)"
        )
    rank = dist.get_rank()
    return Mesh(data, model, torch.device(devices[rank]))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) axis over 'data'; replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def _as_tensor(a, device):
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a)).to(device)


def shard_batch(mesh: Optional[Mesh], *arrays):
    """This rank's block of rows of each global batch (every rank holds
    the global batch; the rows of data index d are block d)."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = tuple(
        batch_sharding(mesh, np.ndim(a)).local_block(_as_tensor(a, mesh.device))
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


def shard_padded_batch(mesh: Optional[Mesh], x):
    """Zero-pad the batch axis to a multiple of the 'data' axis and shard.

    Returns (this rank's rows, n_real) — callers gather the ranks' results
    in row order and cut them back to n_real rows (``gather_rows``)."""
    n_real = int(x.shape[0])
    if mesh is None:
        return x, n_real
    n_data = int(mesh.shape.get("data", 1))
    x = _as_tensor(x, mesh.device)
    if n_data <= 1:
        return x, n_real
    pad = (-n_real) % n_data
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return shard_batch(mesh, x), n_real


def gather_rows(mesh: Optional[Mesh], rows: list, n_real: int) -> list:
    """The data ranks' per-row results (any picklable objects) joined in
    row order and cut to the first n_real rows."""
    if mesh is None or mesh.shape["data"] == 1:
        return list(rows)[:n_real]
    parts = D.all_gather_object(list(rows), mesh.data_group)
    return [r for part in parts for r in part][:n_real]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def replicate(mesh: Optional[Mesh], tree):
    """Every tensor of the tree on the rank's device, with rank 0's values
    (a broadcast over the world)."""
    if mesh is None:
        return tree

    def put(t):
        out = t.detach().to(mesh.device).clone()
        return D.broadcast(out, src=0)

    return _tree_map(put, tree)


# -- tensor-parallel sharding rules ---------------------------------------

# param-path regex -> PartitionSpec. Matmul-heavy weights split over the
# 'model' axis: qkv/mlp1 column-sharded, out/mlp2 row-sharded, so each
# block needs one all-reduce per attention/MLP (the Megatron layout).
TP_RULES: Tuple[Tuple[str, P], ...] = (
    (r".*\.attn\.(query|key|value)\.w$", P(None, "model")),
    (r".*\.attn\.(query|value)\.b$", P("model")),
    (r".*\.cross_attn\.(query|key|value)\.w$", P(None, "model")),
    (r".*\.cross_attn\.(query|value)\.b$", P("model")),
    (r".*\.attn\.out\.w$", P("model", None)),
    (r".*\.cross_attn\.out\.w$", P("model", None)),
    (r".*\.mlp1\.w$", P(None, "model")),
    (r".*\.mlp1\.b$", P("model")),
    (r".*\.mlp2\.w$", P("model", None)),
    (r"decoder\.token_embedding$", P(None, None)),
)


def spec_for_param(path: str, rules=TP_RULES) -> P:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return P()


def param_shardings(mesh: Mesh, params, rules=TP_RULES):
    """Tree of NamedShardings for tensor-parallel parameter placement."""
    from ..models.convert import flatten_params, unflatten_params

    flat = flatten_params(params)
    specs = {k: NamedSharding(mesh, spec_for_param(k, rules)) for k in flat}
    return unflatten_params(specs)


def place_params(params, shardings):
    """Each rank's block of every tensor of a global tree, per a tree of
    NamedShardings; the blocks remember their global shape."""
    from ..models.convert import flatten_params, unflatten_params

    flat_sh = flatten_params(shardings)
    out = {}
    for k, t in flatten_params(params).items():
        sh = flat_sh[k]
        block = sh.local_block(t).contiguous().to(sh.mesh.device).clone()
        out[k] = _mark(block, t.shape)
    return unflatten_params(out)


def shard_params(mesh: Optional[Mesh], params, tensor_parallel: bool = False):
    """Place parameters on the mesh (replicated, or each rank's TP block),
    with rank 0's values."""
    if mesh is None:
        return params
    params = replicate(mesh, params)
    if not tensor_parallel or mesh.shape.get("model", 1) == 1:
        return params
    return place_params(params, param_shardings(mesh, params))


# -- FSDP / ZeRO-3 parameter sharding ---------------------------------------


def fsdp_param_shardings(
    mesh: Mesh, params, tensor_parallel: bool = False, rules=TP_RULES
):
    """FSDP (ZeRO-3) parameter placement: every parameter split over the
    mesh 'data' axis on its largest free divisible axis, on top of its
    Megatron spec when ``tensor_parallel``. Tensors with no divisible free
    axis stay replicated. The training step all-gathers a layer's slices
    where the layer runs (and again in its backward) and reduce-scatters
    their gradients (``train/step.py``)."""
    from ..models.convert import flatten_params, unflatten_params

    data_size = int(mesh.shape.get("data", 1))
    specs = {}
    for k, v in flatten_params(params).items():
        base = spec_for_param(k, rules) if tensor_parallel else P()
        specs[k] = NamedSharding(mesh, zero1_spec(global_shape(v), data_size, base))
    return unflatten_params(specs)


# -- ZeRO-1 optimizer-state sharding ---------------------------------------


def zero1_spec(shape, data_size: int, base: P = P()) -> P:
    """Extend ``base`` (the tensor's TP spec, P() when pure-DP) with 'data'
    on the largest axis that is unsharded and divisible by data_size."""
    entries = list(base) + [None] * (len(shape) - len(base))
    best, best_dim = -1, 0
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % data_size == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return base
    entries[best] = "data"
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def opt_state_shardings(
    mesh: Mesh,
    tx,
    params,
    tensor_parallel: bool = False,
    zero1: bool = True,
    rules=TP_RULES,
):
    """Shardings of ``tx.init(params)``: an ``OptState`` whose mu/nu/
    acc_grads tables hold a NamedSharding per tensor (the counts are
    scalars, replicated). Each moment takes its parameter's TP spec when
    ``tensor_parallel``; with ``zero1`` the spec is extended with 'data'
    on the largest free divisible axis (ZeRO-1)."""
    from ..models.convert import flatten_params

    data_size = int(mesh.shape.get("data", 1)) if zero1 else 1
    shapes = {k: global_shape(v) for k, v in flatten_params(params).items()}
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    template = tx.init(meta)

    def sharding(name: str) -> NamedSharding:
        base = spec_for_param(name, rules) if tensor_parallel else P()
        if data_size > 1:
            base = zero1_spec(shapes[name], data_size, base)
        return NamedSharding(mesh, base)

    template.mu = {n: sharding(n) for n in template.mu}
    template.nu = {n: sharding(n) for n in template.nu}
    template.acc_grads = {n: sharding(n) for n in template.acc_grads}
    return template

