"""Micro-batching inference service: request queue -> fixed device batches.

Counterpart of ``whisper_ipa_tpu/serve.py`` (greedy branch). Callers submit
audio of any length and get futures; a scheduler thread coalesces pending
requests into fixed-size batches of 30 s windows (the tail padded with
silence), runs waveform -> log-mel (K1 on CUDA) -> encoder -> int8
cross-KV greedy decode on the service's device, and resolves the futures.

Not ported yet (the constructor raises ``NotImplementedError``): weight
quantization (``quant_bits``), speculative decoding (draft model, Medusa
heads), multi-device meshes, beam search and the int4 cross cache. The
HTTP front end (``whisper_ipa_tpu/cli/serve.py``) is not ported either.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from whisper_ipa_tpu.audio import N_SAMPLES, load_audio, pad_or_trim
from whisper_ipa_tpu.config import WhisperConfig
from whisper_ipa_tpu.tokenizer import WhisperTokenizer, get_tokenizer

from .decode import DecodingOptions, decode
from .models.convert import params_to
from .ops.mel_kernel import log_mel_spectrogram


@dataclass
class _Request:
    chunks: List[np.ndarray]  # 30 s windows of one utterance
    future: Future
    submitted_at: float
    # called from the scheduler thread once per decoded window with
    # {"window", "n_windows", "text", "partial_text"}; must be fast and
    # thread-safe (e.g. queue.put)
    on_partial: Optional[Callable[[dict], None]] = None


class TranscriptionService:
    """Thread-safe micro-batching transcription service on one device.

    device: where the model runs ("cuda", "cuda:1", "cpu"); the parameters
    are moved there. batch_size: fixed device batch (tail padded with
    silence). max_wait_ms: how long a request waits for the batch to fill.
    """

    def __init__(
        self,
        params,
        cfg: WhisperConfig,
        *,
        device: Union[str, torch.device],
        batch_size: int = 8,
        max_wait_ms: float = 50.0,
        language: Optional[str] = "en",
        beam_size: Optional[int] = None,
        bf16: bool = True,
        kv_int8: bool = True,
        kv_int4: bool = False,
        quant_bits: Optional[int] = None,
        draft_params=None,
        draft_cfg: Optional[WhisperConfig] = None,
        medusa_params=None,
        medusa_tree=None,
        mesh=None,
        tokenizer: Optional[WhisperTokenizer] = None,
    ):
        unported = {
            "quant_bits": quant_bits is not None,
            "draft_params/draft_cfg": draft_params is not None
            or draft_cfg is not None,
            "medusa_params/medusa_tree": medusa_params is not None
            or medusa_tree is not None,
            "mesh": mesh is not None,
            "beam_size": beam_size is not None,
            "kv_int4": kv_int4,
        }
        missing = [name for name, used in unported.items() if used]
        if missing:
            raise NotImplementedError(
                "not ported to the PyTorch service yet: " + ", ".join(missing)
            )
        self.device = torch.device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.tokenizer = tokenizer or get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language or "en",
        )
        self.options = DecodingOptions(
            language=language,
            without_timestamps=True,
            fp16=bf16,
            kv_int8=kv_int8,
        )
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "windows": 0}
        self._thread = threading.Thread(target=self._scheduler, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------

    def submit(
        self,
        audio: Union[str, np.ndarray],
        on_partial: Optional[Callable[[dict], None]] = None,
    ) -> Future:
        """Submit audio (path or 16 kHz waveform); resolves to {"text",
        "segments", "latency_sec"}. on_partial streams one dict per decoded
        30 s window before the future resolves."""
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)
        chunks = [
            pad_or_trim(audio[s:s + N_SAMPLES])
            for s in range(0, max(len(audio), 1), N_SAMPLES)
        ]
        fut: Future = Future()
        self._queue.put(_Request(chunks, fut, time.time(), on_partial))
        with self._stats_lock:
            self._stats["requests"] += 1
        return fut

    def transcribe(self, audio, timeout: Optional[float] = None) -> dict:
        return self.submit(audio).result(timeout=timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- scheduler --------------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Block for the first request, then fill up to batch_size windows
        or until max_wait_ms elapses."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        n_windows = len(first.chunks)
        deadline = time.time() + self.max_wait_ms / 1000.0
        while n_windows < self.batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(req)
            n_windows += len(req.chunks)
        return batch

    def _decode_windows(self, group: List[np.ndarray]):
        """One fixed-size batch of 30 s windows -> DecodingResults."""
        audio = torch.from_numpy(np.stack(group)).to(self.device)
        with torch.inference_mode():
            mels = log_mel_spectrogram(audio, n_mels=self.cfg.n_mels)
        return decode(
            self.params, self.cfg, mels, self.options, tokenizer=self.tokenizer
        )

    def _scheduler(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # resolve the futures with the error
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _run_batch(self, batch: List[_Request]):
        windows: List[np.ndarray] = []
        owners: List[int] = []
        for i, req in enumerate(batch):
            windows.extend(req.chunks)
            owners.extend([i] * len(req.chunks))

        results_per_req: List[list] = [[] for _ in batch]
        for start in range(0, len(windows), self.batch_size):
            group = windows[start:start + self.batch_size]
            group_owners = owners[start:start + self.batch_size]
            n_real = len(group)
            group = group + [np.zeros(N_SAMPLES, np.float32)] * (
                self.batch_size - n_real
            )
            results = self._decode_windows(group)
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["windows"] += n_real
            for k in range(n_real):
                owner = group_owners[k]
                results_per_req[owner].append(results[k])
                req = batch[owner]
                if req.on_partial is not None:
                    done = results_per_req[owner]
                    try:
                        req.on_partial(
                            {
                                "window": len(done) - 1,
                                "n_windows": len(req.chunks),
                                "text": results[k].text,
                                "partial_text": "".join(r.text for r in done),
                            }
                        )
                    except Exception:
                        pass  # a slow or broken consumer must not stall
                        # the batch pipeline

        for req, res in zip(batch, results_per_req):
            req.future.set_result(
                {
                    "text": "".join(r.text for r in res),
                    "segments": [
                        {
                            "id": j,
                            "text": r.text,
                            "avg_logprob": r.avg_logprob,
                            "no_speech_prob": r.no_speech_prob,
                        }
                        for j, r in enumerate(res)
                    ],
                    "latency_sec": time.time() - req.submitted_at,
                }
            )
