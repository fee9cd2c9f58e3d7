"""PyTorch port: the numpy parameter bridge, seeded init, and imports.

The port's tree and the JAX package's tree share the canonical flat names
of ``whisper_ipa_tpu.models.convert.flatten_params``; a round trip through
the port must give back the JAX arrays bit for bit.
"""

import ast
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.models import init_params, params_from_numpy, params_to_numpy

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)


@pytest.fixture(scope="module")
def jax_flat():
    return {
        k: np.asarray(v)
        for k, v in jax_flatten_params(jax_init_params(JCFG, seed=0)).items()
    }


def test_round_trip_is_bit_equal(jax_flat):
    back = params_to_numpy(params_from_numpy(jax_flat))
    assert back.keys() == jax_flat.keys()
    for name, arr in jax_flat.items():
        assert back[name].dtype == arr.dtype, name
        assert back[name].shape == arr.shape, name
        assert np.array_equal(back[name], arr), name


def test_bridge_copies(jax_flat):
    """The port's tree owns its memory: editing it leaves the source."""
    params = params_from_numpy(jax_flat)
    params["decoder"]["ln"]["g"].add_(1.0)
    assert np.array_equal(jax_flat["decoder.ln.g"], np.ones(JCFG.n_text_state))


def test_init_matches_reference_layout(jax_flat):
    """Same names, shapes, dtypes and init scales as the JAX init (the
    random numbers differ: another generator)."""
    ours = params_to_numpy(init_params(CFG, seed=0))
    assert ours.keys() == jax_flat.keys()
    for name, arr in jax_flat.items():
        assert ours[name].shape == arr.shape, name
        assert ours[name].dtype == arr.dtype, name
        if name.endswith((".g", ".b")) or name.endswith("positional_embedding"):
            assert np.array_equal(ours[name], arr), name  # ones / zeros
        else:
            # init std within 10% of the reference's draw
            assert abs(ours[name].std() / arr.std() - 1.0) < 0.1, name


def test_init_is_seeded():
    a = params_to_numpy(init_params(CFG, seed=3))
    b = params_to_numpy(init_params(CFG, seed=3))
    c = params_to_numpy(init_params(CFG, seed=4))
    name = "decoder.blocks.0.attn.query.w"
    assert np.array_equal(a[name], b[name])
    assert not np.array_equal(a[name], c[name])


# modules the learning slice added; the scan must reach each of them
LEARNING_SLICE_MODULES = [
    "whisper_ipa_torch.data.synth",
    "whisper_ipa_torch.metrics.native",
    "whisper_ipa_torch.audio.native",
    "whisper_ipa_torch.metrics.analysis",
    "whisper_ipa_torch.cli.error_analysis",
    "whisper_ipa_torch.utils",
    "whisper_ipa_torch.utils.timing",
    "whisper_ipa_torch.utils.trees",
]
# modules the host-tools slice added (data preparation, zero-shot, tools)
TOOLS_SLICE_MODULES = [
    "whisper_ipa_torch.data.prep",
    "whisper_ipa_torch.data.prep.tables",
    "whisper_ipa_torch.data.prep.preprocess",
    "whisper_ipa_torch.data.prep.zeroshot",
    "whisper_ipa_torch.data.prep.g2p.japanese",
    "whisper_ipa_torch.data.prep.g2p.derive_ja_readings",
    "whisper_ipa_torch.utils.flops",
    "whisper_ipa_torch.utils.xlsx",
    "whisper_ipa_torch.cli.evaluate_zeroshot",
    "whisper_ipa_torch.cli.benchmark_models",
    "whisper_ipa_torch.cli.profile_inference",
    "whisper_ipa_torch.cli.prepare_datasets",
    "whisper_ipa_torch.cli.calculate_real_speed",
]
# modules the parallel slice added (torch.distributed meshes)
PARALLEL_SLICE_MODULES = [
    "whisper_ipa_torch.parallel",
    "whisper_ipa_torch.parallel.distributed",
    "whisper_ipa_torch.parallel.mesh",
    "whisper_ipa_torch.parallel.sharded",
]
# libraries the card's machine does not have: no port module may need them
ABSENT_ON_THE_CARD = ("pandas", "openpyxl")
# modules the speculative-decoding slice added
SPECULATIVE_SLICE_MODULES = [
    "whisper_ipa_torch.decode.speculative",
    "whisper_ipa_torch.decode.medusa_tree",
    "whisper_ipa_torch.models.medusa",
    "whisper_ipa_torch.cli.train_medusa",
    "whisper_ipa_torch.cli.distill_draft",
]

# modules the chunked-training slice added
CHUNKING_SLICE_MODULES = [
    "whisper_ipa_torch.train.chunking",
    "whisper_ipa_torch.cli.bench_decode_kernel",
    "whisper_ipa_torch.cli.bench_quant_decode",
]


def test_port_never_imports_jax():
    """Importing every module of the port loads neither jax nor any module
    of the JAX package (not even one that holds no JAX), nor pandas or
    openpyxl. The two ctypes modules raise on import, by design, where
    native/libwipa_native.so is not built; they are imported whenever it
    is."""
    code = (
        "import importlib, os, pkgutil, sys\n"
        "import whisper_ipa_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "whisper_ipa_torch.__path__, 'whisper_ipa_torch.')]\n"
        "built = os.path.isfile(os.path.join('native', 'libwipa_native.so'))\n"
        "for n in names:\n"
        "    if built or not n.endswith('.native'):\n"
        "        importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'whisper_ipa_tpu')) "
        "or m.split('.')[0] in ('pandas', 'openpyxl'))\n"
        "assert not bad, bad\n"
        "print('\\n'.join(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO_ROOT,
    )
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 30  # every module was imported
    assert set(LEARNING_SLICE_MODULES) <= set(names)
    assert set(SPECULATIVE_SLICE_MODULES) <= set(names)
    assert set(TOOLS_SLICE_MODULES) <= set(names)
    assert set(PARALLEL_SLICE_MODULES) <= set(names)
    assert set(CHUNKING_SLICE_MODULES) <= set(names)


def _imported_modules(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_chip_smoke_imports_nothing_of_jax():
    """chip_smoke.py (every import, at any depth) names neither jax nor the
    JAX package."""
    names = _imported_modules(os.path.join(REPO_ROOT, "chip_smoke.py"))
    assert "whisper_ipa_torch" in {n.split(".")[0] for n in names}
    bad = sorted(
        n for n in names if n.split(".")[0] in ("jax", "jaxlib", "whisper_ipa_tpu")
    )
    assert not bad, bad


def test_port_sources_never_import_pandas_or_openpyxl():
    """No module of the port, and not chip_smoke.py, names pandas or
    openpyxl in an import (at any depth): the card's machine has neither."""
    root = os.path.join(REPO_ROOT, "whisper_ipa_torch")
    paths = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "build"]  # build outputs
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 60
    bad = {p: sorted(n for n in _imported_modules(p)
                     if n.split(".")[0] in ABSENT_ON_THE_CARD)
           for p in paths}
    assert not {p: b for p, b in bad.items() if b}
