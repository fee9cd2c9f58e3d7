"""Data, Megatron tensor, ZeRO-1 and FSDP parallelism over
``torch.distributed`` (one process a device); the counterpart of
``whisper_ipa_tpu.parallel``, with its names."""

from .distributed import (
    global_batch_from_local,
    initialize,
    local_shard_indices,
    process_info,
)
from .mesh import (
    TP_RULES,
    batch_sharding,
    fsdp_param_shardings,
    make_mesh,
    opt_state_shardings,
    param_shardings,
    replicate,
    shard_batch,
    shard_params,
    spec_for_param,
    shard_padded_batch,
    zero1_spec,
)

__all__ = [
    "TP_RULES",
    "batch_sharding",
    "fsdp_param_shardings",
    "global_batch_from_local",
    "initialize",
    "local_shard_indices",
    "make_mesh",
    "opt_state_shardings",
    "param_shardings",
    "process_info",
    "replicate",
    "shard_batch",
    "shard_params",
    "spec_for_param",
    "shard_padded_batch",
    "zero1_spec",
]
