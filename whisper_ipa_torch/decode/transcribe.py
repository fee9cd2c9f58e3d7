"""Long-form transcription: a file or waveform -> text, window by window.

Counterpart of ``whisper_ipa_tpu/decode/transcribe.py``. Audio is cut into
30 s windows on the host; their log-mel runs on the parameters' device (K1,
``ops/mel_kernel.log_mel_spectrogram``, on CUDA), and by default all
windows decode as one batch. Whisper's temperature ladder retries the
windows whose compression ratio or average log-probability fails its gate,
and the no-speech gate drops silent windows. Two other modes decode window
after window: ``condition_on_previous_text`` (each window prompted with the
last tokens before it) and ``sequential_timestamps`` (decode with
timestamps and move to the last complete segment, as mlx_whisper does).
``word_timestamps`` adds per-phone times (``decode/word_timestamps.py``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..audio import N_SAMPLES, SAMPLE_RATE, load_audio, pad_or_trim
from ..config import WhisperConfig
from ..ops.mel_kernel import log_mel_spectrogram
from ..tokenizer import WhisperTokenizer, get_tokenizer
from .decoding import DecodingOptions, DecodingResult, _device_of, decode

PROMPT_PAD_LEN = 64  # fixed conditioning-prompt length


def chunk_audio(audio: np.ndarray) -> List[np.ndarray]:
    """Split audio into 30 s windows (last window zero-padded)."""
    if len(audio) == 0:
        return [np.zeros(N_SAMPLES, np.float32)]
    return [pad_or_trim(audio[start:start + N_SAMPLES])
            for start in range(0, len(audio), N_SAMPLES)]


def _fixed_length_prompt(
    tokens, sot_prev: int, length: int = PROMPT_PAD_LEN,
    n_text_ctx: Optional[int] = None,
):
    """The last ``length`` prompt tokens, left-padded with sot_prev; the
    length is capped at n_text_ctx // 2 - 1 (Whisper's prompt budget), so
    the prefix never overruns the positional embedding."""
    if n_text_ctx is not None:
        length = min(length, n_text_ctx // 2 - 1)
    tokens = list(tokens)[-length:]
    return [sot_prev] * (length - len(tokens)) + tokens


def parse_timestamp_segments(tokens, timestamp_begin: int):
    """Split a timestamped token stream into segments.

    Returns (segments, seek_advance_frames): segments are (start_frame,
    end_frame, text_tokens) triples; the seek advance follows Whisper's
    rule: the last *consecutive* timestamp pair if there is one, else None
    (consume the whole window).
    """
    ts_positions = [i for i, t in enumerate(tokens) if t >= timestamp_begin]
    consecutive_ends = [
        ts_positions[k + 1]
        for k in range(len(ts_positions) - 1)
        if ts_positions[k + 1] == ts_positions[k] + 1
    ]
    segments = []
    start_idx = None
    for i, t in enumerate(tokens):
        if t < timestamp_begin:
            continue
        if start_idx is None:
            start_idx = i
            continue
        text = [x for x in tokens[start_idx + 1:i] if x < timestamp_begin]
        if text:
            segments.append(
                (tokens[start_idx] - timestamp_begin, t - timestamp_begin, text)
            )
        start_idx = i
    if consecutive_ends:
        return segments, tokens[consecutive_ends[-1]] - timestamp_begin
    return segments, None


def _log_mel(params, cfg: WhisperConfig, windows: List[np.ndarray]):
    """(n, N_SAMPLES) windows -> (n, 3000, n_mels) log-mel on the
    parameters' device."""
    audio = torch.from_numpy(np.stack(windows)).to(_device_of(params))
    with torch.inference_mode():
        return log_mel_spectrogram(audio, n_mels=cfg.n_mels)


def _temperatures(temperature) -> tuple:
    if isinstance(temperature, (int, float)):
        return (temperature,)
    return tuple(temperature)


def _fails_gate(r: DecodingResult, compression_ratio_threshold,
                logprob_threshold) -> bool:
    return (
        compression_ratio_threshold is not None
        and r.compression_ratio > compression_ratio_threshold
    ) or (logprob_threshold is not None and r.avg_logprob < logprob_threshold)


def _is_silent(r: DecodingResult, no_speech_threshold,
               logprob_threshold) -> bool:
    return (
        no_speech_threshold is not None
        and r.no_speech_prob > no_speech_threshold
        and (logprob_threshold is None or r.avg_logprob < logprob_threshold)
    )


def transcribe(
    params,
    cfg: WhisperConfig,
    audio: Union[str, np.ndarray],
    *,
    language: Optional[str] = "en",
    temperature: Union[float, tuple] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    beam_size: Optional[int] = None,
    word_timestamps: bool = False,
    condition_on_previous_text: bool = False,
    sequential_timestamps: bool = False,
    tokenizer: Optional[WhisperTokenizer] = None,
    **decode_kwargs,
) -> dict:
    """Transcribe a file path or float32 16 kHz waveform; returns {"text",
    "segments", "language"}.

    Long-form modes:
      - default: every 30 s window in one decode batch
      - condition_on_previous_text=True: windows in turn, each prompted
        with the previous windows' last tokens (<|startofprev|>)
      - sequential_timestamps=True: windows in turn, decoded with
        timestamps, the next window starting at the last segment boundary;
        the result also lists, under "windows", each window's start,
        temperature and the branch that took its decode: "silent" (the
        no-speech gate skipped it), "timestamp pairs", "whole window" (text
        without a closing timestamp) or "no text"

    word_timestamps=True adds per-IPA-phone times to each segment.
    ``decode_kwargs`` go to every ``DecodingOptions`` (e.g. sample_len,
    fp16, kv_int8).
    """
    if isinstance(audio, str):
        audio = load_audio(audio)
    audio = np.asarray(audio, dtype=np.float32)
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language or "en",
        )

    if sequential_timestamps:
        return _transcribe_sequential_timestamps(
            params, cfg, audio, language=language, tokenizer=tokenizer,
            temperature=temperature,
            compression_ratio_threshold=compression_ratio_threshold,
            logprob_threshold=logprob_threshold,
            no_speech_threshold=no_speech_threshold,
            condition_on_previous_text=condition_on_previous_text,
            **decode_kwargs,
        )

    mels = _log_mel(params, cfg, chunk_audio(audio))
    temperatures = _temperatures(temperature)

    def options(t: float, prompt=None) -> DecodingOptions:
        return DecodingOptions(
            language=language, without_timestamps=True, temperature=t,
            beam_size=beam_size if t == 0.0 else None, prompt=prompt,
            **decode_kwargs,
        )

    def run_sequential(t: float) -> List[DecodingResult]:
        results: List[DecodingResult] = []
        prev_tokens: List[int] = []
        for i in range(len(mels)):
            prompt = (
                _fixed_length_prompt(prev_tokens, tokenizer.sot_prev,
                                     n_text_ctx=cfg.n_text_ctx)
                if prev_tokens else None
            )
            r = decode(params, cfg, mels[i:i + 1], options(t, prompt),
                       tokenizer=tokenizer)[0]
            results.append(r)
            prev_tokens = (prev_tokens + r.tokens)[-PROMPT_PAD_LEN:]
        return results

    if condition_on_previous_text and len(mels) > 1:
        results = run_sequential(temperatures[0])
    else:
        results = decode(params, cfg, mels, options(temperatures[0]),
                         tokenizer=tokenizer)
    # the ladder: retry the failed windows at each higher temperature (as
    # in the reference, a retry takes no decode_kwargs)
    for t in temperatures[1:]:
        needs_retry = [
            i for i, r in enumerate(results)
            if _fails_gate(r, compression_ratio_threshold, logprob_threshold)
        ]
        if not needs_retry:
            break
        retried = decode(
            params, cfg, mels[needs_retry],
            DecodingOptions(language=language, without_timestamps=True,
                            temperature=t),
            tokenizer=tokenizer,
        )
        for i, r in zip(needs_retry, retried):
            results[i] = r

    segments = []
    texts = []
    for i, r in enumerate(results):
        if _is_silent(r, no_speech_threshold, logprob_threshold):
            continue
        segment = {
            "id": i,
            "start": i * 30.0,
            "end": min((i + 1) * 30.0, len(audio) / SAMPLE_RATE),
            "text": r.text,
            "tokens": r.tokens,
            "avg_logprob": r.avg_logprob,
            "no_speech_prob": r.no_speech_prob,
            "compression_ratio": r.compression_ratio,
            "temperature": r.temperature,
        }
        if word_timestamps and r.tokens:
            from .word_timestamps import phone_timestamps

            window_secs = min(30.0, len(audio) / SAMPLE_RATE - i * 30.0)
            phones = phone_timestamps(
                params, cfg, r.tokens, mels[i:i + 1], tokenizer=tokenizer,
                audio_seconds=max(window_secs, 0.1),
            )
            offset = i * 30.0
            segment["phones"] = [
                {"phone": p["phone"], "start": p["start"] + offset,
                 "end": p["end"] + offset}
                for p in phones
            ]
        segments.append(segment)
        texts.append(r.text)
    return {"text": "".join(texts), "segments": segments, "language": language}


def _transcribe_sequential_timestamps(
    params,
    cfg: WhisperConfig,
    audio: np.ndarray,
    *,
    language: Optional[str] = "en",
    tokenizer: Optional[WhisperTokenizer] = None,
    max_windows: int = 200,
    temperature: Union[float, tuple] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = False,
    **decode_kwargs,
) -> dict:
    """Whisper's long-form loop: decode each window WITH timestamps and
    move to the last complete segment boundary (not a fixed 30 s jump).

    The temperature ladder runs per window, a silent window (no-speech
    gate) moves a whole window without emitting, and
    condition_on_previous_text prompts with the accumulated tokens (reset
    after a fallback above 0.5, and across silence).
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language or "en",
        )
    ts_begin = tokenizer.timestamp_begin
    frame_sec = 0.02
    temperatures = _temperatures(temperature)

    def decode_window(mel, prompt) -> DecodingResult:
        r = None
        for t in temperatures:
            options = DecodingOptions(
                language=language, without_timestamps=False, temperature=t,
                prompt=prompt if t <= 0.5 else None, **decode_kwargs,
            )
            r = decode(params, cfg, mel, options, tokenizer=tokenizer)[0]
            if not _fails_gate(r, compression_ratio_threshold,
                               logprob_threshold):
                return r
        return r

    segments = []
    texts = []
    windows = []  # each window's start, temperature and branch
    seek = 0  # in samples
    window = 0
    prev_tokens: List[int] = []
    while seek < len(audio) and window < max_windows:
        mel = _log_mel(params, cfg, [pad_or_trim(audio[seek:seek + N_SAMPLES])])
        prompt = (
            _fixed_length_prompt(prev_tokens, tokenizer.sot_prev,
                                 n_text_ctx=cfg.n_text_ctx)
            if condition_on_previous_text and prev_tokens else None
        )
        r = decode_window(mel, prompt)
        windows.append({"start": seek / SAMPLE_RATE,
                        "temperature": r.temperature, "branch": "silent"})

        if _is_silent(r, no_speech_threshold, logprob_threshold):
            seek += N_SAMPLES
            window += 1
            prev_tokens = []  # no conditioning across silence
            continue

        if condition_on_previous_text:
            if r.temperature > 0.5:
                prev_tokens = []  # Whisper: reset after a hot fallback
            else:
                prev_tokens = (prev_tokens + r.tokens)[-PROMPT_PAD_LEN:]

        window_segments, advance = parse_timestamp_segments(r.tokens, ts_begin)
        offset_sec = seek / SAMPLE_RATE
        n_kept = len(segments)
        for s_frame, e_frame, text_tokens in window_segments:
            text = tokenizer.decode_text(text_tokens).strip()
            if not text:
                continue
            segments.append({
                "id": len(segments),
                "start": offset_sec + s_frame * frame_sec,
                "end": offset_sec + e_frame * frame_sec,
                "text": text,
                "tokens": text_tokens,
                "avg_logprob": r.avg_logprob,
                "no_speech_prob": r.no_speech_prob,
                "temperature": r.temperature,
            })
            texts.append(text)
        if not window_segments and r.text.strip():
            # text without closing timestamps: keep it, over the window
            segments.append({
                "id": len(segments),
                "start": offset_sec,
                "end": min(offset_sec + 30.0, len(audio) / SAMPLE_RATE),
                "text": r.text.strip(),
                "tokens": r.tokens,
                "avg_logprob": r.avg_logprob,
                "no_speech_prob": r.no_speech_prob,
                "temperature": r.temperature,
            })
            texts.append(r.text.strip())
        windows[-1]["branch"] = (
            "no text" if len(segments) == n_kept
            else "timestamp pairs" if window_segments else "whole window")

        if advance is not None and advance > 0:
            seek += int(advance * frame_sec * SAMPLE_RATE)
        else:
            seek += N_SAMPLES
        window += 1

    return {"text": "".join(texts), "segments": segments,
            "language": language, "windows": windows}
