"""The FLOP, byte and roofline counts against hand counts at small shapes,
and the per-layer readers on a synthetic trace."""

import pytest

from benchmark.harness import registry
from benchmark.harness.trace import Stretch
from benchmark.roofline import flops, kernels, peaks

H100 = "NVIDIA H100 80GB HBM3"


def test_encoder_decoder_and_training_flops_by_hand():
    # n_mels 2, d 4, one layer, 3 audio positions
    conv1, conv2 = 2 * 6 * 3 * 2 * 4, 2 * 3 * 3 * 4 * 4
    layer = 8 * 3 * 16 + 4 * 9 * 4 + 16 * 3 * 16
    assert flops.encoder_flops(2, 4, 1, 3) == conv1 + conv2 + layer == 1872
    # d 4, one layer, vocabulary 10, 2 positions, 3 audio positions
    cross, per_tok = 4 * 3 * 16, 8 * 16 + 4 * 16 + 16 * 16 + 4 * 3 * 4
    assert flops.decoder_flops(4, 1, 10, 2, 3) == cross + per_tok * 2 + 4 * 4 * 3 + 2 * 4 * 10 * 2
    dec_fwd = 4 * 3 * 16 + (28 * 16 + 4 * 3 * 4) * 2 + 4 * 4 * 2 + 2 * 4 * 10 * 2
    assert flops.train_step_flops(2, 4, 1, 10, 2, 3) == 1872 + 3 * dec_fwd


@pytest.mark.parametrize("model", ["small", "large-v3"])
def test_the_copied_formulas_equal_the_programs(model):
    from whisper_ipa_torch.config import get_config
    from whisper_ipa_torch.utils import flops as prog

    cfg = get_config(model)
    d, L = cfg.n_audio_state, cfg.n_audio_layer
    assert flops.encoder_flops(cfg.n_mels, d, L) == prog.encoder_flops(cfg)
    assert flops.decoder_flops(d, L, cfg.n_vocab, 4 + 63) == prog.decoder_flops(cfg, 63, 4)
    assert flops.train_step_flops(cfg.n_mels, d, L, cfg.n_vocab, 100) == \
        prog.train_step_flops(cfg, 100)


def test_kernel_bytes_and_operations_by_hand():
    assert kernels.encoder_attention(2, 3, 4) == (4 * 2 * 3 * 4 * 2, 4.0 * 2 * 3 * 3 * 4)
    n_bytes, n_flops = kernels.int8_cross_attention(2, 5, 4, q_bytes=2)
    assert n_bytes == 2 * 2 * 4 * 5 + 2 * 2 * 5 * 4 + 2 * 2 * 4 * 2
    assert n_flops == 4.0 * 2 * 5 * 4
    assert peaks.bound_s(H100, 3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(H100, 1.0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s("another card", 1.0, 1.0) is None


def _facts():
    dims = registry.dims(registry.cell("small.eval-long")["config_file"])
    st = Stretch()
    st.spans = [("encode", 0.0, 1000.0), ("decode", 1000.0, 5000.0)]
    st.device = [("attention_fwd_wgmma<64>", 100.0, 300.0),
                 ("gemm", 300.0, 800.0),
                 ("decode_int8_cluster_kernel<bf16>", 1000.0, 1500.0),
                 ("elementwise", 2000.0, 2500.0)]
    return {"kind": "eval_batch", "dims": dims, "batch": 2, "sample_len": 3,
            "n_prefix": 4, "spans": {"encode": [0.5, 0.7], "decode": [0.3]},
            "walls": [2.0, 2.0], "stretch": st, "device_name": H100}


def test_readers_on_a_synthetic_stretch():
    f = _facts()
    read = registry.read_metrics(f, ["audio_s_per_s"])
    d = f["dims"]
    k2_bytes, k2_flops = kernels.encoder_attention(2 * 12, 1500, 64)
    k2 = 100 * d["encoder_layers"] * peaks.bound_s(H100, k2_bytes, k2_flops) / 200e-6
    assert read["k2_roofline.eval"]["value"] == pytest.approx(k2)
    k4_bytes, k4_flops = kernels.int8_cross_attention(2 * 12, 1500, 64, q_bytes=2)
    k4 = 100 * d["decoder_layers"] * 2 * peaks.bound_s(H100, k4_bytes, k4_flops) / 500e-6
    assert read["k4_roofline.eval"]["value"] == pytest.approx(k4)
    assert read["device_idle_pct.eval"]["value"] == pytest.approx(100 * (1 - 1700 / 5000))
    assert read["launches_per_step.eval"]["value"] == pytest.approx(2 / 3)
    assert read["decode_step_ms.eval"]["value"] == pytest.approx(100.0)
    assert read["encode_ms.eval"]["value"] == pytest.approx(600.0)
    row = flops.encoder_flops(80, 768, 12) + flops.decoder_flops(768, 12, 51865, 4 + 2)
    assert read["mfu.eval"]["value"] == pytest.approx(100 * 2 * row / 2.0 / 989e12)
    assert not any(n.endswith(".train") for n in read)


def test_readers_find_nothing_to_read_without_a_trace():
    f = dict(_facts(), stretch=None, walls=[])
    read = registry.read_metrics(f, ["audio_s_per_s"])
    assert set(read) == {"decode_step_ms.eval", "encode_ms.eval"}
