"""PyTorch port: the numpy parameter bridge, seeded init, and imports.

The port's tree and the JAX package's tree share the canonical flat names
of ``whisper_ipa_tpu.models.convert.flatten_params``; a round trip through
the port must give back the JAX arrays bit for bit.
"""

import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from whisper_ipa_tpu.config import CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_torch.models import init_params, params_from_numpy, params_to_numpy

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)


@pytest.fixture(scope="module")
def jax_flat():
    return {
        k: np.asarray(v)
        for k, v in jax_flatten_params(jax_init_params(CFG, seed=0)).items()
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
    assert np.array_equal(jax_flat["decoder.ln.g"], np.ones(CFG.n_text_state))


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


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import whisper_ipa_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "whisper_ipa_torch.__path__, 'whisper_ipa_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)),
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12  # every module was imported
