"""The plain reference agrees with the program at a tiny size in float32:
the log-mel, the encoder, the teacher-forced decoder and its loss, and
one clipped AdamW step. The float8 control departs from it."""

import pytest
import torch

from benchmark.harness import audio, registry, weights
from benchmark.harness.program import whisper_config
from benchmark.reference import mel as ref_mel
from benchmark.reference import whisper as ref
from benchmark.reference.adamw import AdamW
from benchmark.reference.precision import FP8, FP32
from benchmark.tests import tiny

SEED = 17


def _setup(name="small.eval-long"):
    c = tiny.cell(name)
    dims = registry.dims(c["config_file"])
    cfg = whisper_config(dims, "tiny")
    return dims, cfg, weights.make_params(dims, SEED, "cpu")


def _waves(n, lo=1.0, hi=6.0):
    g = torch.Generator().manual_seed(SEED)
    return audio.speech_batch(audio.stratified_lengths(n, lo, hi, g), g, "cpu")


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_the_programs(n_mels):
    from whisper_ipa_torch.ops import log_mel_spectrogram

    w = _waves(2)
    got = log_mel_spectrogram(w, n_mels)
    want = ref_mel.log_mel(w, n_mels)
    assert got.shape == want.shape == (2, 3000, n_mels)
    assert float((got - want).abs().max()) < 1e-4


def test_encoder_decoder_and_loss_match_the_programs_in_float32():
    from whisper_ipa_torch.models.whisper import decoder_logits, encode
    from whisper_ipa_torch.train.loss import compute_loss

    dims, cfg, params = _setup()
    mel = ref_mel.log_mel(_waves(2), dims["n_mels"])
    with torch.no_grad():
        got = encode(params, cfg, mel)
        want = ref.encode_blocks(params, dims["encoder_heads"], mel, rows=1)
        assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())
        toks = torch.tensor([[50258, 50259, 50359, 50363, 11, 22, 33, 50257, 50257],
                             [50258, 50259, 50359, 50363, 44, 55, 50257, 50257, 50257]])
        lg = decoder_logits(params, cfg, toks, want)
        lg_ref = ref.decoder_logits(params, dims["decoder_heads"], toks, want)
        assert float((lg - lg_ref).abs().max()) < 1e-4 * float(lg_ref.abs().max())
        loss = compute_loss(params, cfg, None, toks, 50257, audio_features=want)
        loss_ref = ref.loss(params, dims["decoder_heads"], toks, want, 50257)
        assert abs(float(loss) - float(loss_ref)) < 1e-5 * float(loss_ref)
        lg_c = ref.decoder_logits(params, dims["decoder_heads"], toks, want, prec=FP8)
        assert float((lg_c - lg_ref).abs().max()) > 1e-3 * float(lg_ref.abs().max())


def test_one_clipped_adamw_step_matches_the_programs():
    from whisper_ipa_torch.train.optimizer import Optimizer

    g = torch.Generator().manual_seed(3)
    p = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(11, generator=g)}
    grads = {"a": 3.0 * torch.randn(5, 7, generator=g), "b": 0.1 * torch.randn(11, generator=g)}
    mine = {k: v.clone() for k, v in p.items()}
    theirs = {k: v.clone() for k, v in p.items()}
    opt = AdamW(1e-3, 1.0, 0.01)
    tx = Optimizer(learning_rate=1e-3, max_grad_norm=1.0, freeze_encoder=False)
    state = tx.init(theirs)
    for _ in range(2):
        opt.step(mine, grads)
        tx.step(theirs, grads, state)
    for k in p:
        # two steps of about 1e-3 each, equal to a unit or two in the last place
        assert torch.allclose(mine[k], theirs[k], rtol=0, atol=2.5e-7)
        assert float((mine[k] - p[k]).abs().min()) > 1e-4
        assert torch.allclose(opt.mu[k], state.mu[k], rtol=1e-6, atol=1e-9)


def test_float8_rounds_to_the_e4m3_grid():
    x = torch.tensor([448.0, 1.0, 0.3, -17.0])
    y = FP8.round(x)
    assert float(y[0]) == 448.0 and float(y[1]) == 1.0
    assert float(y[2]) != 0.3 and abs(float(y[2]) - 0.3) < 0.3 / 16
    assert torch.equal(FP32.round(x), x)
