"""PyTorch port: what the decode loop's CUDA-graph path rests on, on the CPU.

A graph replays its step at whatever position a device tensor holds, so
``decode_step`` takes the position as a 0-d tensor and must compute what
the Python int computes; the loop takes the graph path only on CUDA,
without a tensor-parallel group and without a sampling generator, so the
CPU and TP loops never capture; and a span records nothing while the
current stream captures. The graph path itself runs on the card
(``tests/test_torch_cuda.py``).
"""

from dataclasses import replace
from unittest import mock

import pytest
import torch
import torch.distributed as dist

from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import DecodingOptions, decode
from whisper_ipa_torch.decode import decoding
from whisper_ipa_torch.models import decode_step, init_cache, init_params
from whisper_ipa_torch.parallel.sharded import TensorParallel
from whisper_ipa_torch.utils import timing

torch.set_num_threads(1)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=48)
EOT = 50257


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0, device="cpu")


@pytest.fixture(scope="module")
def feats():
    gen = torch.Generator().manual_seed(0)
    return torch.randn((3, CFG.n_audio_ctx, CFG.n_audio_state), generator=gen)


def _options():
    """Greedy, every id from EOT up suppressed: each row decodes 10 tokens."""
    return DecodingOptions(language="en", without_timestamps=True, sample_len=10,
                           suppress_blank=False,
                           suppress_tokens=list(range(EOT, CFG.n_vocab)))


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("S,pos", [(4, 0), (1, 4), (1, 9), (3, 5)])
def test_decode_step_position_as_a_device_value(params, feats, S, pos, kv_int8):
    """The same step at ``pos`` given as a Python int and as a 0-d long
    tensor, each on its own cache holding the same earlier rows: the
    logits equal bit for bit, and so does every self-cache row, the S
    written at pos included."""
    gen = torch.Generator().manual_seed(S * 100 + pos)
    tokens = torch.randint(0, EOT, (3, S), generator=gen)
    history = torch.randint(0, EOT, (3, pos), generator=gen) if pos else None
    out = []
    with torch.inference_mode():
        for as_tensor in (False, True):
            cache = init_cache(params, CFG, feats, max_len=16, cross_kv_int8=kv_int8)
            if history is not None:  # rows < pos: the step reads them
                decode_step(params, CFG, history, cache, 0)
            p = torch.tensor(pos) if as_tensor else pos
            logits, cache = decode_step(params, CFG, tokens, cache, p)
            out.append((logits, cache))
    (l_int, c_int), (l_dev, c_dev) = out
    assert l_int.shape == (3, S, CFG.n_vocab)
    assert torch.equal(l_int, l_dev)
    assert torch.equal(c_int.self_k, c_dev.self_k)
    assert torch.equal(c_int.self_v, c_dev.self_v)
    assert c_dev.self_k[:, :, pos:pos + S].abs().sum() > 0  # the rows were written


@pytest.mark.parametrize("device,tp,sampling,expected", [
    ("cuda", False, False, True),
    ("cpu", False, False, False),
    ("cuda", True, False, False),
    ("cuda", False, True, False),
])
def test_the_graph_path_is_chosen_by_input(device, tp, sampling, expected):
    """The graph path needs CUDA tensors, no TP group (its gloo
    collectives cannot be captured) and no sampling generator (a replay
    would not advance it); nothing else decides it."""
    group = object() if tp else None
    gen = torch.Generator() if sampling else None
    assert decoding._graph_path(torch.device(device), group, gen) is expected


def _no_capture(*a, **k):
    raise AssertionError("the eager loop tried a capture")


@pytest.mark.parametrize("with_tp", [False, True])
def test_cpu_and_tp_loops_never_capture(params, feats, with_tp):
    """On the CPU, alone and under a one-rank gloo TP group, ``decode``
    runs the eager loop: no capture is tried, no graph is made, no
    ``decode.capture`` or ``decode.replay`` is recorded, and the TP
    loop's tokens are the plain loop's."""
    tp = None
    if with_tp:
        tp = TensorParallel(dist.ProcessGroupGloo(dist.HashStore(), 0, 1), 1, 0)
    with mock.patch.object(decoding, "_capture_step", side_effect=_no_capture), \
            mock.patch.object(torch.cuda, "CUDAGraph", side_effect=_no_capture):
        with timing.tracing():
            got = decode(params, CFG, feats, _options(), tp=tp)
        recs = timing.records()
    names = [r.name for r in recs]
    assert names.count("decode.step") == 10
    assert "decode.capture" not in names and "decode.replay" not in names
    plain = decode(params, CFG, feats, _options())
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    assert [r.avg_logprob for r in got] == [r.avg_logprob for r in plain]


def test_spans_record_nothing_while_capturing():
    """Inside ``tracing()``, while the current stream captures (mocked:
    CUDA initialised, the stream capturing) a span is the shared no-op
    and adds no record, and the recording is not reset; once the capture
    ends spans record again, after the ones before it."""
    with timing.tracing():
        with timing.span("before"):
            pass
        with mock.patch.object(torch.cuda, "is_initialized", return_value=True), \
                mock.patch.object(torch.cuda, "is_current_stream_capturing",
                                  return_value=True):
            inside = timing.span("inside")
            assert inside is timing.span("other")
            with inside:
                pass
        with timing.span("after"):
            pass
    assert [r.name for r in timing.records()] == ["before", "after"]
