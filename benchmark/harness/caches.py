"""The run's caches, at fixed paths inside the checkout, set before
PyTorch loads: the program builds its CUDA libraries in
``whisper_ipa_torch/build/`` (its own choice); Triton's and PyTorch's
extension caches and CUDA's JIT cache go under ``.bench_cache/``. The
libraries that would load Flax or TensorFlow by themselves are told not
to."""

import os


def use_checkout_caches(root: str) -> None:
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
