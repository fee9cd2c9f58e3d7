"""PyTorch port: ``train.loss.compute_distill_loss`` against the JAX
package, on the CPU.

Same weights (numpy bridge), same seeded batch, f32: the port's loss (CE
to the data plus T^2 KL to a frozen teacher, over the first-EOT-kept mask)
and its gradients match JAX's, no graph reaches the teacher, and
self-distillation is pure CE, as ``tests/test_distill.py`` checks for the
reference.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_ipa_tpu.config import CONFIGS as JAX_CONFIGS
from whisper_ipa_tpu.models import flatten_params as jax_flatten_params
from whisper_ipa_tpu.models import init_params as jax_init_params
from whisper_ipa_tpu.train.loss import compute_distill_loss as jax_distill
from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.models import (
    flatten_params,
    params_from_numpy,
    unflatten_params,
)
from whisper_ipa_torch.train.loss import compute_distill_loss, compute_loss

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
JCFG = replace(JAX_CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
N_MEL_FRAMES = CFG.n_audio_ctx * 2
EOT = 50257


@pytest.fixture(scope="module")
def models():
    """JAX teacher (seed 0) and student (seed 7), and the port's copies."""
    jt, jd = jax_init_params(JCFG, seed=0), jax_init_params(JCFG, seed=7)

    def bridge(jparams):
        return params_from_numpy(
            {k: np.asarray(v) for k, v in jax_flatten_params(jparams).items()})

    return dict(jt=jt, jd=jd, t=bridge(jt), d=bridge(jd))


@pytest.fixture(scope="module")
def distill_batch():
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)
    tok = np.full((2, 8), EOT, np.int32)
    tok[:, :4] = [50258, 50259, 50359, 50363]
    tok[0, 4:6] = [100, 200]
    tok[1, 4:7] = [300, 400, 500]
    return mel, tok


def test_distill_loss_and_grads_match_jax(models, distill_batch):
    mel, tok = distill_batch
    kw = dict(alpha=0.7, temperature=2.0)

    def jloss(sp):
        return jax_distill(sp, models["jt"], JCFG, JCFG, jnp.asarray(mel),
                           jnp.asarray(tok), EOT, **kw)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(models["jd"])
    flat = {k: v.clone().requires_grad_(True)
            for k, v in flatten_params(models["d"]).items()}
    loss = compute_distill_loss(unflatten_params(flat), models["t"], CFG, CFG,
                                torch.from_numpy(mel), torch.from_numpy(tok).long(),
                                EOT, **kw)
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    jflat = {k: np.asarray(v) for k, v in jax_flatten_params(jgrads).items()}
    for (name, g) in zip(flat, grads):
        scale = max(float(np.abs(jflat[name]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, jflat[name] / scale,
                                   rtol=0, atol=2e-4, err_msg=name)
    # the teacher is frozen: no graph reaches its tensors
    assert not any(t.requires_grad for t in flatten_params(models["t"]).values())


def test_self_distillation_is_pure_ce(models, distill_batch):
    """KL(teacher || student) is 0 for one model, so the loss is
    (1 - alpha) CE."""
    mel, tok = distill_batch
    mel, tok = torch.from_numpy(mel), torch.from_numpy(tok).long()
    with torch.no_grad():
        ce = float(compute_loss(models["t"], CFG, mel, tok, EOT,
                                freeze_encoder=False))
        d = float(compute_distill_loss(models["t"], models["t"], CFG, CFG, mel,
                                       tok, EOT, alpha=0.5))
    assert d == pytest.approx(0.5 * ce, rel=1e-4)
    with pytest.raises(ValueError, match="vocabulary"):
        compute_distill_loss(models["t"], models["t"], CFG,
                             replace(CFG, n_vocab=CFG.n_vocab + 1), mel, tok, EOT)
