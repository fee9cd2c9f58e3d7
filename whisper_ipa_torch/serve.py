"""Micro-batching inference service: request queue -> fixed device batches.

Counterpart of ``whisper_ipa_tpu/serve.py`` (its greedy and beam
branches). Callers submit audio of any length and get futures; a scheduler
thread coalesces pending requests into fixed-size batches of 30 s windows
(the tail padded with silence), runs waveform -> log-mel (K1 on CUDA) ->
encoder -> int8 cross-KV greedy decode, beam search with ``beam_size``, or
speculative decoding (below), on the service's device, and resolves the
futures.

``quant_bits`` (8 or 4) quantizes the block weights at startup
(``ops/quant.quantize_params``) before they move to the device; ``kv_int4``
keeps the cross cache as nibble-packed int4 (and overrides ``kv_int8``).

Speculative decoding: ``draft_params``/``draft_cfg`` (a draft model,
``draft_k`` tokens a round; its own log-mel through K1 when its ``n_mels``
differs) or ``medusa_params`` (Medusa heads, chain, or tree with
``medusa_tree``) send each batch to ``speculative_decode`` or
``medusa_tree_decode``, whose tokens are ``decode()``'s. They exclude
``beam_size`` and each other; ``draft_k`` alone is inert. The service has
no n-gram mode, as the reference's has none: n-gram drafts serve in the
in-flight engine.

Over a mesh (``parallel.make_mesh``, one process a device), every rank
builds the service with the same arguments: the parameters are
replicated, or Megatron-sharded over 'model' with ``tensor_parallel``
(the draft model's parameters and the Medusa heads replicated, so every
rank of a tensor-parallel group drafts alike). Rank 0 owns the queue and
the scheduler; each batch's windows are broadcast to the other ranks,
which run ``follow()`` (the command channel is ``parallel.leader.Leader``,
as the in-flight engine's). Every rank computes the log-mel of its data block
of rows (K1; the draft's own log-mel too when its ``n_mels`` differs) and
decodes it, speculatively or not, and rank 0 gathers the results in row
order.
The HTTP front end over it is ``cli/serve.py``.
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

from .audio import N_SAMPLES, load_audio, pad_or_trim
from .config import WhisperConfig
from .decode import (DecodingOptions, decode, medusa_tree_decode,
                     speculative_decode)
from .models.convert import params_to
from .ops.mel_kernel import log_mel_spectrogram
from .parallel import distributed as D
from .parallel.leader import Leader
from .parallel.mesh import batch_sharding, gather_rows, replicate, shard_params
from .ops.quant import quantize_params
from .tokenizer import WhisperTokenizer, get_tokenizer
from .train.loop import resolve_device


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

    device: where the model runs ("cuda" by default, "cuda:1", "cpu"); the
    parameters are moved there, and "cuda" without a card raises.
    batch_size: fixed device batch (tail padded with
    silence). max_wait_ms: how long a request waits for the batch to fill.
    """

    def __init__(
        self,
        params,
        cfg: WhisperConfig,
        *,
        device: Union[str, torch.device] = "cuda",
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
        draft_k: int = 4,
        medusa_params=None,
        medusa_tree=None,
        mesh=None,
        tensor_parallel: bool = False,
        tokenizer: Optional[WhisperTokenizer] = None,
    ):
        if mesh is not None:
            n_data = mesh.shape.get("data", 1)
            if batch_size % n_data != 0:
                raise ValueError(
                    f"batch_size={batch_size} must be divisible by the "
                    f"mesh's data axis ({n_data})"
                )
            if quant_bits is not None and tensor_parallel:
                raise ValueError(
                    "tensor_parallel serving with quant_bits is not "
                    "supported (TP sharding rules address unquantized "
                    "weight paths)"
                )
        if (draft_params is not None or medusa_params is not None) and (
            beam_size is not None
        ):
            raise ValueError(
                "speculative decoding (draft/medusa) excludes beam_size"
            )
        if draft_params is not None and medusa_params is not None:
            raise ValueError("choose ONE of draft_params / medusa_params")
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params requires draft_cfg")
        if medusa_tree is not None and medusa_params is None:
            raise ValueError("medusa_tree needs medusa_params")
        self.mesh = mesh
        self.tp = (mesh.tp if mesh is not None and tensor_parallel
                   else None)
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self._lead = Leader(self.device, enabled=mesh is not None)
        self.draft_cfg = draft_cfg
        self.draft_k = draft_k
        self.draft_params = (None if draft_params is None
                             else params_to(draft_params, self.device))
        self.medusa_params = (None if medusa_params is None
                              else params_to(medusa_params, self.device))
        self.medusa_tree = tuple(medusa_tree) if medusa_tree else None
        if quant_bits is not None:
            params = quantize_params(params, bits=quant_bits)
        if mesh is not None:
            params = shard_params(mesh, params,
                                  tensor_parallel=tensor_parallel)
            if self.draft_params is not None:
                self.draft_params = replicate(mesh, self.draft_params)
            if self.medusa_params is not None:
                self.medusa_params = replicate(mesh, self.medusa_params)
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
            beam_size=beam_size,
            fp16=bf16,
            kv_int8=kv_int8 and not kv_int4,
            kv_int4=kv_int4,
        )
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "windows": 0}
        self._thread = None
        self._leader = mesh is None or torch.distributed.get_rank() == 0
        if self._leader:
            self._thread = threading.Thread(target=self._scheduler,
                                            daemon=True)
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
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- over a mesh: rank 0 leads, the others follow ----------------------

    _BATCH = 0  # rank 0's command to the other ranks (``follow()``)

    def follow(self) -> None:
        """A follower rank's loop: run each batch rank 0 broadcasts, until
        it stops (``close()`` on rank 0). Without a mesh there is nothing
        to follow."""
        if not self._leader:
            self._lead.follow(
                {self._BATCH: lambda _: self._decode_windows(None)})

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

    def _decode_windows(self, group: Optional[List[np.ndarray]]):
        """One fixed-size batch of 30 s windows -> DecodingResults. Over a
        mesh every rank calls it (a follower with ``group`` None): rank
        0's windows are broadcast, each rank decodes its data block, and
        rank 0 gets every row's result."""
        if self.mesh is None:
            return self._decode_rows(
                torch.from_numpy(np.stack(group)).to(self.device))
        audio = torch.empty((self.batch_size, N_SAMPLES), dtype=torch.float32,
                            device=self.device)
        if group is not None:
            audio.copy_(torch.from_numpy(np.stack(group)))
        D.broadcast(audio, src=0)
        mine = batch_sharding(self.mesh, 2).local_block(audio)
        results = self._decode_rows(mine)
        return gather_rows(self.mesh, results, self.batch_size)

    def _decode_rows(self, audio: torch.Tensor):
        with torch.inference_mode():
            mels = log_mel_spectrogram(audio, n_mels=self.cfg.n_mels)
        if self.medusa_tree is not None:
            return medusa_tree_decode(
                self.params, self.cfg, self.medusa_params, mels,
                self.options, tree=self.medusa_tree, tokenizer=self.tokenizer,
                tp=self.tp,
            )
        if self.medusa_params is not None:
            return speculative_decode(
                self.params, self.cfg, None, None, mels, self.options,
                tokenizer=self.tokenizer, medusa_params=self.medusa_params,
                tp=self.tp,
            )
        if self.draft_params is not None:
            draft_mels = None
            if self.draft_cfg.n_mels != self.cfg.n_mels:
                with torch.inference_mode():
                    draft_mels = log_mel_spectrogram(
                        audio, n_mels=self.draft_cfg.n_mels)
            return speculative_decode(
                self.params, self.cfg, self.draft_params, self.draft_cfg,
                mels, self.options, draft_k=self.draft_k,
                draft_mel=draft_mels, tokenizer=self.tokenizer, tp=self.tp,
            )
        return decode(
            self.params, self.cfg, mels, self.options, tokenizer=self.tokenizer,
            tp=self.tp,
        )

    def _scheduler(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                self._lead.beat()
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # resolve the futures with the error
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
                if self.mesh is not None:
                    self._lead.fail()  # release the followers
                    raise  # and stop the leader
        self._lead.stop()

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
            with self._lead.command(self._BATCH):
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
