"""JSON dataset -> batched (mel, tokens) with caching and async prefetch.

Schema (reference CLAUDE.md:91-94): a JSON array of entries with
``audio_path``, ``ipa_transcription``, optional ``speaker_id`` /
``dataset_source``. Tokenization contract
(reference scripts/ipa_data_loader.py:102-131):
``sot_sequence_including_notimestamps + BPE(ipa) + EOT``, rows padded with
EOT to the batch max.

Counterpart of ``whisper_ipa_tpu/data/dataset.py``, with the same cache
files, batches and sampling order:

  - optional persistent mel cache (one .npy per utterance, float16 on disk);
    mels are computed on the host by the NumPy log-mel, or beforehand on a
    device by ``precompute_mels`` (K1 on CUDA)
  - a background prefetch thread assembles upcoming batches while the
    device runs the current step, sampling with
    ``np.random.default_rng(seed)`` and padding tokens to power-of-two
    buckets
  - ``precompute_features`` caches the frozen encoder's outputs, computed
    by this package's encoder
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ..audio import load_audio, log_mel_spectrogram, pad_or_trim
from ..tokenizer import WhisperTokenizer, get_tokenizer


class IPADataset:
    """Audio + IPA transcription dataset."""

    def __init__(
        self,
        json_path: str,
        tokenizer: WhisperTokenizer,
        n_mels: int = 80,
        mel_cache_dir: Optional[str] = None,
        num_workers: int = 0,
        max_token_len: int = 448,
    ):
        self.json_path = json_path
        self.tokenizer = tokenizer
        self.n_mels = n_mels
        self.mel_cache_dir = mel_cache_dir
        self.num_workers = num_workers
        # hard cap = n_text_ctx: longer rows would overrun the decoder's
        # positional embedding and abort the training run
        self.max_token_len = max_token_len
        self._truncation_warned = False
        # optional frozen-encoder feature cache (see precompute_features):
        # when set, get_batch returns encoder outputs instead of mels
        self.feature_cache_dir: Optional[str] = None
        self._pool = None
        if mel_cache_dir:
            os.makedirs(mel_cache_dir, exist_ok=True)

        if str(json_path).endswith(".jsonl"):
            # JSON-lines: streaming-friendly for very large corpora
            self.data = []
            with open(json_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self.data.append(json.loads(line))
        else:
            with open(json_path) as f:
                self.data = json.load(f)
        print(f"Loaded {len(self.data)} samples from {json_path}")

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        entry = self.data[idx]
        audio = load_audio(entry["audio_path"])
        return {
            "audio": audio,
            "ipa_text": entry["ipa_transcription"],
            "audio_path": entry["audio_path"],
            "metadata": {
                "speaker_id": entry.get("speaker_id", "unknown"),
                "dataset_source": entry.get("dataset_source", "unknown"),
            },
        }

    # -- mel extraction with optional disk cache --------------------------

    def _cache_path(self, audio_path: str) -> str:
        h = hashlib.sha1(
            f"{audio_path}:{self.n_mels}".encode()
        ).hexdigest()[:24]
        return os.path.join(self.mel_cache_dir, f"{h}.npy")

    def mel(self, idx: int) -> np.ndarray:
        """(3000, n_mels) float32 log-mel for sample idx."""
        audio_path = self.data[idx]["audio_path"]
        if self.mel_cache_dir:
            path = self._cache_path(audio_path)
            if os.path.isfile(path):
                return np.load(path).astype(np.float32)
        audio = pad_or_trim(load_audio(audio_path))
        m = log_mel_spectrogram(audio, n_mels=self.n_mels)
        if self.mel_cache_dir:
            np.save(self._cache_path(audio_path), m.astype(np.float16))
        return m

    def precompute_mels(self, device, batch_size: int = 16) -> int:
        """Fill the mel cache on ``device``: the log-mel of every uncached
        utterance through ``ops.log_mel_spectrogram`` (K1 on CUDA), saved
        as the float16 file ``mel()`` reads. Returns the number computed."""
        import torch

        from ..ops.mel_kernel import log_mel_spectrogram as device_log_mel

        if not self.mel_cache_dir:
            raise ValueError("precompute_mels needs a mel_cache_dir")
        paths = [e["audio_path"] for e in self.data]
        todo = [p for p in dict.fromkeys(paths)
                if not os.path.isfile(self._cache_path(p))]
        for start in range(0, len(todo), batch_size):
            group = todo[start:start + batch_size]
            audio = np.stack([pad_or_trim(load_audio(p)) for p in group])
            with torch.inference_mode():
                mels = device_log_mel(
                    torch.from_numpy(audio).to(device), n_mels=self.n_mels
                ).to(torch.float16).cpu().numpy()
            for path, m in zip(group, mels):
                np.save(self._cache_path(path), m)
        return len(todo)

    # -- frozen-encoder feature cache --------------------------------------

    def _feature_path(self, audio_path: str) -> str:
        h = hashlib.sha1(
            f"{audio_path}:feat:{self.n_mels}".encode()
        ).hexdigest()[:24]
        return os.path.join(self.feature_cache_dir, f"{h}.npy")

    def features(self, idx: int) -> np.ndarray:
        """(n_audio_ctx, d) cached encoder output for sample idx."""
        path = self._feature_path(self.data[idx]["audio_path"])
        return np.load(path).astype(np.float32)

    def precompute_features(
        self, params, cfg, cache_dir: str, batch_size: int = 16,
        dtype_name: str = "bfloat16",
    ) -> int:
        """Run the frozen encoder once over the whole dataset and cache the
        outputs (float16 on disk, ~4.6 MB/sample for whisper-small).

        The encoder is frozen during fine-tuning, so its activations are
        constant per sample — caching them removes ~2/3 of each train
        step's FLOPs (the reference recomputes the encoder every step).
        Returns the number of samples encoded (skips existing entries).
        The encoder runs on the parameters' device.
        """
        import torch

        from ..models.convert import flatten_params
        from ..models.whisper import encode

        device = flatten_params(params)["decoder.token_embedding"].device
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            dtype_name
        ]

        os.makedirs(cache_dir, exist_ok=True)
        self.feature_cache_dir = cache_dir
        todo = [
            i for i in range(len(self.data))
            if not os.path.isfile(
                self._feature_path(self.data[i]["audio_path"])
            )
        ]
        if not todo:
            return 0
        done = 0
        for start in range(0, len(todo), batch_size):
            idxs = todo[start : start + batch_size]
            mels = np.stack([self.mel(i) for i in idxs])
            n_real = len(idxs)
            with torch.inference_mode():
                feats = encode(
                    params, cfg, torch.from_numpy(mels).to(device), dtype=dtype
                ).to(torch.float16).cpu().numpy()
            for k, i in enumerate(idxs):
                np.save(
                    self._feature_path(self.data[i]["audio_path"]), feats[k]
                )
            done += n_real
            if done % (batch_size * 8) == 0 or done == len(todo):
                print(f"  encoder cache: {done}/{len(todo)}")
        return done

    # -- batching ---------------------------------------------------------

    def _tokenize_ipa_batch(self, ipa_texts: Sequence[str]) -> np.ndarray:
        tokenized = []
        for text in ipa_texts:
            tokens = list(self.tokenizer.sot_sequence_including_notimestamps)
            tokens.extend(self.tokenizer.encode(text))
            tokens.append(self.tokenizer.eot)
            if len(tokens) > self.max_token_len:
                # keep the final EOT so the loss mask stays well-formed
                tokens = tokens[: self.max_token_len - 1] + [
                    self.tokenizer.eot
                ]
                if not self._truncation_warned:
                    self._truncation_warned = True
                    print(
                        "Warning: transcript exceeded "
                        f"{self.max_token_len} tokens and was truncated "
                        "(further truncations not reported)"
                    )
            tokenized.append(tokens)
        max_len = max(len(t) for t in tokenized)
        eot = self.tokenizer.eot
        return np.asarray(
            [t + [eot] * (max_len - len(t)) for t in tokenized],
            dtype=np.int32,
        )

    def get_batch(
        self, indices: Sequence[int], pad_tokens_to: Optional[int] = None
    ) -> Dict:
        """Assemble a batch: stacked mels + EOT-padded token matrix.

        pad_tokens_to: optionally right-pad the token matrix to a fixed
        length (bucketing keeps jit recompilation bounded).
        """
        if self.feature_cache_dir:
            mels = np.stack([self.features(i) for i in indices])
        elif self.num_workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(self.num_workers)
            mels = np.stack(list(self._pool.map(self.mel, indices)))
        else:
            mels = np.stack([self.mel(i) for i in indices])
        texts = [self.data[i]["ipa_transcription"] for i in indices]
        tokens = self._tokenize_ipa_batch(texts)
        if pad_tokens_to is not None and tokens.shape[1] < pad_tokens_to:
            pad = np.full(
                (tokens.shape[0], pad_tokens_to - tokens.shape[1]),
                self.tokenizer.eot,
                np.int32,
            )
            tokens = np.concatenate([tokens, pad], axis=1)
        return {
            "mel_features": mels,
            "tokens": tokens,
            "ipa_texts": texts,
            "audio_paths": [self.data[i]["audio_path"] for i in indices],
        }


def create_data_loader(
    json_path: str,
    multilingual: bool = True,
    n_mels: int = 80,
    language: str = "en",
    mel_cache_dir: Optional[str] = None,
    tokenizer: Optional[WhisperTokenizer] = None,
    num_workers: int = 0,
) -> IPADataset:
    """Reference-surface factory (scripts/ipa_data_loader.py:134-157).

    num_workers > 1 parallelizes per-sample audio decode + mel extraction
    across threads (the reference was pinned to a single worker,
    REFERENCE.md:25).
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(multilingual=multilingual, language=language)
    return IPADataset(
        json_path,
        tokenizer,
        n_mels=n_mels,
        mel_cache_dir=mel_cache_dir,
        num_workers=num_workers,
    )


class _LoaderError:
    """Sentinel carrying a worker exception to the consuming thread."""

    def __init__(self, error: Exception):
        self.error = error


def _round_up_pow2(n: int, minimum: int = 32) -> int:
    out = minimum
    while out < n:
        out *= 2
    return out


class PrefetchLoader:
    """Background-thread batch producer for the training loop.

    Samples random batches (without replacement within a batch, matching
    reference np.random.choice at scripts/train_whisper_ipa.py:548) and
    keeps `depth` ready batches ahead of the consumer. Token matrices are
    padded to power-of-two buckets so the jitted train step compiles a
    bounded number of shapes.
    """

    def __init__(
        self,
        dataset: IPADataset,
        batch_size: int,
        num_steps: int,
        seed: int = 0,
        depth: int = 2,
        bucket_tokens: bool = True,
        max_token_len: int = 448,
        fixed_token_len: Optional[int] = None,
    ):
        """fixed_token_len: pad every batch's token matrix to exactly
        this length (overrides bucketing). Multi-host training needs it:
        each host pads its LOCAL rows independently, and the global
        batch assembly requires identical shapes on every process."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.bucket_tokens = bucket_tokens and fixed_token_len is None
        self.max_token_len = max_token_len
        self.fixed_token_len = fixed_token_len
        self._rng = np.random.default_rng(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for _ in range(self.num_steps):
                if self._stop.is_set():
                    break
                try:
                    self._queue.put(self._produce_one())
                except Exception as e:  # surface errors to the consumer
                    self._queue.put(_LoaderError(e))
                    return
        finally:
            self._queue.put(None)

    def _produce_one(self) -> Dict:
        # without replacement within a batch (reference behavior); with
        # replacement when the dataset is smaller than the batch, so the
        # batch size stays fixed for DP sharding
        indices = self._rng.choice(
            len(self.dataset),
            size=self.batch_size,
            replace=self.batch_size > len(self.dataset),
        ).tolist()
        batch = self.dataset.get_batch(indices)
        if self.fixed_token_len is not None:
            tokens = batch["tokens"]
            if tokens.shape[1] < self.fixed_token_len:
                pad = np.full(
                    (tokens.shape[0], self.fixed_token_len - tokens.shape[1]),
                    self.dataset.tokenizer.eot,
                    np.int32,
                )
                batch["tokens"] = np.concatenate([tokens, pad], axis=1)
            elif tokens.shape[1] > self.fixed_token_len:
                # never emit a wider batch than promised: multi-host
                # global-batch assembly requires identical widths on
                # every process. Truncate, keeping a terminal EOT so
                # the loss mask still finds an end on every row.
                trunc = np.ascontiguousarray(
                    tokens[:, : self.fixed_token_len]
                )
                trunc[:, -1] = self.dataset.tokenizer.eot
                batch["tokens"] = trunc
        if self.bucket_tokens:
            tokens = batch["tokens"]
            target = min(_round_up_pow2(tokens.shape[1]), self.max_token_len)
            if tokens.shape[1] < target:
                pad = np.full(
                    (tokens.shape[0], target - tokens.shape[1]),
                    self.dataset.tokenizer.eot,
                    np.int32,
                )
                batch["tokens"] = np.concatenate([tokens, pad], axis=1)
        return batch

    def __iter__(self) -> Iterator[Dict]:
        while True:
            batch = self._queue.get()
            if batch is None:
                break
            if isinstance(batch, _LoaderError):
                raise RuntimeError(
                    "input pipeline worker failed"
                ) from batch.error
            yield batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
