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
)

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
]
