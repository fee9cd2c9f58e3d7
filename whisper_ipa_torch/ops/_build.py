"""Build the CUDA kernels of ``whisper_ipa_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exports plain C entry points (no PyTorch headers),
so ``nvcc`` builds it in seconds into ``whisper_ipa_torch/build/`` as a
shared library, which ``ctypes`` loads. The library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded. Only the package's own sources go into a build;
a failed build raises.

Calling convention of every entry point: tensors and the CUDA stream are
passed as ``c_void_p`` (``tensor.data_ptr()``,
``torch.cuda.current_stream().cuda_stream``), sizes as ``c_int``; the entry
launches on that stream, does not synchronise, and returns
``cudaGetLastError()``, which ``check`` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

KERNEL_SOURCES = (
    "mel", "attention", "attention_bwd", "decode_attention", "quant_matmul",
    "kv_init", "sr_quant",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then /usr/local."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin)"
    )


def _library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str) -> Path:
    out = _library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return out


def build_all() -> Dict[str, Path]:
    """Compile every kernel source (in parallel) and return their paths."""
    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        paths = list(pool.map(_compile, KERNEL_SOURCES))
    return dict(zip(KERNEL_SOURCES, paths))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiling it on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_compile(name)))
                _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """Entry point ``symbol`` of ``csrc/<name>.cu``, declared with the given
    argtypes and an int return code (built and loaded on first use)."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise if an entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


P = ctypes.c_void_p
I = ctypes.c_int
U32 = ctypes.c_uint32
F32 = ctypes.c_float
