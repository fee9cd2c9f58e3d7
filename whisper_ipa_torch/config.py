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


def get_config(name: str) -> WhisperConfig:
    """Resolve a model name (accepts HF/MLX-style repo ids) to a config."""
    key = name.lower()
    for prefix in ("mlx-community/", "openai/"):
        if key.startswith(prefix):
            key = key[len(prefix):]
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
