from .convert import (
    flatten_params,
    params_from_numpy,
    params_to,
    params_to_numpy,
    unflatten_params,
)
from .whisper import (
    DecoderCache,
    cast_decoder_blocks,
    decode_step,
    decoder_hidden,
    decoder_logits,
    encode,
    init_cache,
    init_params,
    use_fused_kv_init,
)
from .layers import use_int8_activations

__all__ = [
    "DecoderCache",
    "cast_decoder_blocks",
    "decode_step",
    "decoder_hidden",
    "decoder_logits",
    "encode",
    "flatten_params",
    "init_cache",
    "init_params",
    "params_from_numpy",
    "params_to",
    "params_to_numpy",
    "unflatten_params",
    "use_fused_kv_init",
    "use_int8_activations",
]
