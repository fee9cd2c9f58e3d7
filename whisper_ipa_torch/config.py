"""Model dimension registry and typed configuration.

Centralizes what the reference scatters across scripts (e.g. the
``n_mels = 128 if 'large' in model_name else 80`` rule at reference
scripts/train_whisper_ipa.py:517). Dimensions follow the published Whisper
family architecture. The PyTorch package's copy of
``whisper_ipa_tpu/config.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict


@dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def n_audio_head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def n_text_head_dim(self) -> int:
        return self.n_text_state // self.n_text_head

    @property
    def num_languages(self) -> int:
        # multilingual vocab 51865 -> 99 languages; large-v3's 51866 -> 100
        return 99 + (self.n_vocab - 51865)

    @property
    def multilingual(self) -> bool:
        return self.n_vocab >= 51865


def _cfg(name, n_mels, d, h, l, n_vocab=51865) -> WhisperConfig:
    return WhisperConfig(
        name=name,
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=d,
        n_audio_head=h,
        n_audio_layer=l,
        n_vocab=n_vocab,
        n_text_ctx=448,
        n_text_state=d,
        n_text_head=h,
        n_text_layer=l,
    )


CONFIGS: Dict[str, WhisperConfig] = {
    "tiny": _cfg("tiny", 80, 384, 6, 4),
    "base": _cfg("base", 80, 512, 8, 6),
    "small": _cfg("small", 80, 768, 12, 12),
    "medium": _cfg("medium", 80, 1024, 16, 24),
    "large": _cfg("large", 80, 1280, 20, 32),
    "large-v1": _cfg("large-v1", 80, 1280, 20, 32),
    "large-v2": _cfg("large-v2", 80, 1280, 20, 32),
    "large-v3": _cfg("large-v3", 128, 1280, 20, 32, n_vocab=51866),
    "large-v3-turbo": WhisperConfig(
        name="large-v3-turbo",
        n_mels=128,
        n_audio_ctx=1500,
        n_audio_state=1280,
        n_audio_head=20,
        n_audio_layer=32,
        n_vocab=51866,
        n_text_ctx=448,
        n_text_state=1280,
        n_text_head=20,
        n_text_layer=4,
    ),
}
# English-only variants: same dims, 51864-token vocab
for _name in ("tiny", "base", "small", "medium"):
    CONFIGS[f"{_name}.en"] = replace(
        CONFIGS[_name], name=f"{_name}.en", n_vocab=51864
    )

# tiny config for unit tests: full architecture, toy dimensions
CONFIGS["test-tiny"] = WhisperConfig(
    name="test-tiny",
    n_mels=80,
    n_audio_ctx=1500,
    n_audio_state=64,
    n_audio_head=2,
    n_audio_layer=2,
    n_vocab=51865,
    n_text_ctx=448,
    n_text_state=64,
    n_text_head=2,
    n_text_layer=2,
)


@dataclass(frozen=True)
class AudioLLMConfig:
    """An audio language model: a Whisper encoder (``tower``) whose frames a
    linear connector pools to ``n_audio_tokens`` embeddings inside the
    prompt of a decoder-only language model (Qwen2-style: RMSNorm, RoPE,
    grouped-query attention with q/k/v biases) whose MLP is a dynamic-
    capacity mixture of experts: ``n_shared`` SwiGLU experts always on,
    ``n_routed`` routed SwiGLU experts and ``n_null`` null experts under a
    float32 softmax router, each token taking the shortest prefix of its
    sorted probabilities that sums to ``top_p``, at most ``top_k`` of them.
    """

    name: str
    tower: WhisperConfig
    n_audio_tokens: int
    d_model: int
    n_layer: int
    n_head: int
    n_kv_head: int
    head_dim: int
    n_vocab: int
    n_shared: int
    shared_ffn: int
    n_routed: int
    routed_ffn: int
    n_null: int
    top_p: float
    top_k: int
    rms_eps: float
    rope_theta: float
    first_special: int  # the first id of the special tokens
    eos: int

    @property
    def n_slots(self) -> int:
        """The router's outputs: the routed experts, then the null ones."""
        return self.n_routed + self.n_null

    @property
    def n_mels(self) -> int:
        return self.tower.n_mels


# HIT-TMG/Uni-MoE-2.0-Omni (config.json; arXiv:2511.12609): the path from
# speech to text, whisper-large-v3's encoder under a 28-layer language
# model. Qwen2's special ids start at <|endoftext|> 151643; <|im_end|>
# 151645 ends a turn.
AUDIO_LLM_CONFIGS: Dict[str, AudioLLMConfig] = {
    "uni-moe-2.0-omni": AudioLLMConfig(
        name="uni-moe-2.0-omni", tower=CONFIGS["large-v3"], n_audio_tokens=200,
        d_model=3584, n_layer=28, n_head=28, n_kv_head=4, head_dim=128,
        n_vocab=152064, n_shared=2, shared_ffn=2368, n_routed=4,
        routed_ffn=18944, n_null=1, top_p=0.7, top_k=2, rms_eps=1e-6,
        rope_theta=1e6, first_special=151643, eos=151645),
    # the unit tests' size: the same blocks, toy widths
    "test-tiny-omni": AudioLLMConfig(
        name="test-tiny-omni", tower=CONFIGS["test-tiny"], n_audio_tokens=8,
        d_model=64, n_layer=2, n_head=4, n_kv_head=2, head_dim=16,
        n_vocab=512, n_shared=2, shared_ffn=16, n_routed=4, routed_ffn=32,
        n_null=1, top_p=0.7, top_k=2, rms_eps=1e-6, rope_theta=1e6,
        first_special=500, eos=501),
}


def get_config(name: str):
    """Resolve a model name (accepts HF/MLX-style repo ids) to a config: a
    ``WhisperConfig``, or an ``AudioLLMConfig`` for the audio language
    models (``uni-moe-2.0-omni``)."""
    key = name.lower()
    for prefix in ("mlx-community/", "openai/", "hit-tmg/"):
        if key.startswith(prefix):
            key = key[len(prefix):]
    if key in AUDIO_LLM_CONFIGS:
        return AUDIO_LLM_CONFIGS[key]
    key = key.replace("whisper-", "").replace("-mlx", "")
    if key in CONFIGS:
        return CONFIGS[key]
    raise KeyError(f"unknown Whisper model: {name!r} (resolved {key!r})")


def n_mels_for_model(name: str) -> int:
    """The reference's derived-config rule, preserved as an API."""
    try:
        return get_config(name).n_mels
    except KeyError:
        return 128 if "large" in name.lower() else 80
