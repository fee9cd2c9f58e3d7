"""The system under test's configuration object, built from a
configuration file's published sizes (``registry.dims``)."""

from __future__ import annotations

from typing import Dict


def whisper_config(dims: Dict[str, int], name: str):
    from whisper_ipa_torch.config import WhisperConfig

    return WhisperConfig(
        name=name, n_mels=dims["n_mels"], n_audio_ctx=dims["n_audio_ctx"],
        n_audio_state=dims["d_model"], n_audio_head=dims["encoder_heads"],
        n_audio_layer=dims["encoder_layers"], n_vocab=dims["n_vocab"],
        n_text_ctx=dims["n_text_ctx"], n_text_state=dims["d_model"],
        n_text_head=dims["decoder_heads"], n_text_layer=dims["decoder_layers"])
