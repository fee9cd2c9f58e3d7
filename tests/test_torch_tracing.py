"""PyTorch port: the program's spans (``whisper_ipa_torch.utils.timing``)
on the CPU, at test-tiny.

- Off unless a profiler records or ``timing.tracing()`` is open: nothing
  is recorded, and a profiler run after the recorder was last on holds
  no marker of the program.
- Under either, a ``decode`` call's records nest under it in order
  (cast, cache build, prefix, one step an iteration with the finished
  check inside the ninth, readback), with its id as every record's call;
  a training step gives one forward, backward and optimizer record.
- Decoding and training give the same bits with the spans on and off.
- Each span leaves two markers among the profiler's host events, paired
  with its record by id, on the profiler's clock, inside the enclosing
  range, and nothing on the device's timeline; ``train(profile_dir=)``'s
  Chrome trace holds them.
"""

import json
import subprocess
import sys

import pytest
import torch

from whisper_ipa_torch.config import CONFIGS
from whisper_ipa_torch.decode import DecodingOptions, decode
from whisper_ipa_torch.models import init_params
from whisper_ipa_torch.models.convert import flatten_params
from whisper_ipa_torch.train import create_train_state, train, train_chunk, train_step
from whisper_ipa_torch.utils import timing

from test_torch_data import write_dataset

torch.set_num_threads(1)

CFG = CONFIGS["test-tiny"]
EOT = 50257
SAMPLE_LEN = 12
DECODE_CHILDREN = ["decode.cast", "decode.init_cache", "decode.prefix"] + \
    ["decode.step"] * SAMPLE_LEN + ["decode.readback"]
TRAIN_CHILDREN = ["train.forward", "train.backward", "train.optimizer"]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0, device="cpu")


@pytest.fixture(scope="module")
def feats():
    gen = torch.Generator().manual_seed(0)
    return torch.randn((2, CFG.n_audio_ctx, CFG.n_audio_state), generator=gen)


def _options(**kw):
    """Greedy with every id from EOT up suppressed: each row decodes
    SAMPLE_LEN text tokens and the loop never ends early."""
    kw = dict(dict(language="en", without_timestamps=True, sample_len=SAMPLE_LEN,
                   suppress_tokens=list(range(EOT, CFG.n_vocab)),
                   suppress_blank=False), **kw)
    return DecodingOptions(**kw)


def _batch():
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn((2, 2 * CFG.n_audio_ctx, CFG.n_mels), generator=gen)
    tokens = torch.full((2, 10), EOT, dtype=torch.long)
    tokens[:, :4] = torch.tensor([50258, 50259, 50359, 50363])
    tokens[:, 4:8] = torch.randint(0, EOT, (2, 4), generator=gen)
    return mel, tokens


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            fn()
    return prof.events()


def test_spans_record_nothing_by_default(params, feats):
    """A fresh process records nothing; a span entered with recording off
    is the shared no-op; after a tracing block closes, decoding adds no
    record and a profiler run over other work holds no marker."""
    code = ("import torch\n"
            "from whisper_ipa_torch.utils import timing\n"
            "with timing.span('x'):\n"
            "    torch.ones(2).sum()\n"
            "print(len(timing.records()), timing.span('y') is timing.span('z'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.split() == ["0", "True"], out.stderr
    with timing.tracing():
        decode(params, CFG, feats, _options())
    before = [r.id for r in timing.records()]
    decode(params, CFG, feats, _options())
    assert [r.id for r in timing.records()] == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4).cumsum(0)
    assert not [e for e in prof.events() if timing.parse_marker(e.name)]


@pytest.mark.parametrize("how", ["tracing", "profiler"])
def test_decode_records_nest_in_order(params, feats, how):
    """Two ``decode`` calls: each is a root whose id is the call of its
    children, which come in the loop's order; ``decode.finished_check``
    sits inside the ninth step (the first check, at step 8); a new
    recording drops the last one's records."""
    with timing.tracing():
        decode(params, CFG, feats, _options())
    old = {r.id for r in timing.records()}

    def run():
        for _ in range(2):
            decode(params, CFG, feats, _options())

    if how == "tracing":
        with timing.tracing():
            run()
    else:
        _profiled(run)
    recs = timing.records()
    assert old.isdisjoint(r.id for r in recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["decode", "decode"]
    for root in roots:
        assert root.call == root.id
        kids = _children(recs, root)
        assert [k.name for k in kids] == DECODE_CHILDREN
        steps = [k for k in kids if k.name == "decode.step"]
        checks = [g for s in steps for g in _children(recs, s)]
        assert [c.name for c in checks] == ["decode.finished_check"]
        assert checks[0].parent == steps[8].id
        mine = [r for r in recs if r.call == root.id]
        assert len(mine) == len(DECODE_CHILDREN) + 2
        for a, b in zip(mine, mine[1:]):  # in the order they started
            assert a.host_start <= b.host_start
        for k in kids:
            assert root.host_start <= k.host_start <= k.host_end <= root.host_end
            assert k.stream_ms is None  # no CUDA here
    assert roots[0].host_end <= roots[1].host_start


def test_a_finished_batch_ends_the_steps_early(params, feats):
    """Every id but EOT suppressed: each row ends at its first token, and
    the check at step 8 ends the loop, inside the ninth and last
    ``decode.step``; the tokens are empty as without tracing."""
    opts = _options(sample_len=20,
                    suppress_tokens=[t for t in range(CFG.n_vocab) if t != EOT])
    with timing.tracing():
        out = decode(params, CFG, feats, opts)
    recs = timing.records()
    steps = [r for r in recs if r.name == "decode.step"]
    assert len(steps) == 9
    assert [r.name for r in _children(recs, steps[-1])] == ["decode.finished_check"]
    assert sum(r.name == "decode.init_cache" for r in recs) == 1
    assert [r.tokens for r in out] == [[], []]


def test_train_step_records_forward_backward_optimizer(params):
    """A chunk of two steps and one step alone: each step is a
    ``train.step`` root with one forward, one backward and one optimizer
    record, in that order, all of its call."""
    state, tx = create_train_state(_clone(params), learning_rate=1e-4)
    mel, tokens = _batch()
    with timing.tracing():
        state, _ = train_chunk(state, torch.stack([mel, mel]),
                               torch.stack([tokens, tokens]), CFG, tx, EOT)
        train_step(state, mel, tokens, CFG, tx, EOT)
    recs = timing.records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["train.step"] * 3
    for root in roots:
        kids = _children(recs, root)
        assert [k.name for k in kids] == TRAIN_CHILDREN
        assert all(k.call == root.id for k in kids)
        assert not [r for r in recs if r.parent in {k.id for k in kids}]
    assert len({r.call for r in recs}) == 3


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def test_tracing_changes_no_bit(params, feats):
    """Tokens and log-probabilities of ``decode``, and ``train_step``'s
    losses and updated weights, equal bit for bit with the spans on
    (tracing and under the profiler) and off."""
    got = []
    for how in ("off", "tracing", "profiler"):
        def run():
            res = decode(params, CFG, feats, _options())
            state, tx = create_train_state(_clone(params), learning_rate=1e-4)
            mel, tokens = _batch()
            losses = [train_step(state, mel, tokens, CFG, tx, EOT)[1] for _ in range(2)]
            return res, losses, flatten_params(state.params)

        if how == "tracing":
            with timing.tracing():
                got.append(run())
        elif how == "profiler":
            out = []
            _profiled(lambda: out.append(run()))
            got.append(out[0])
        else:
            got.append(run())
    (res0, loss0, p0) = got[0]
    for res, losses, p in got[1:]:
        assert [(r.tokens, r.avg_logprob) for r in res] == \
            [(r.tokens, r.avg_logprob) for r in res0]
        assert all(torch.equal(a, b) for a, b in zip(losses, loss0))
        assert p.keys() == p0.keys()
        assert all(torch.equal(p[n], p0[n]) for n in p0)


def test_markers_sit_on_the_profilers_clock(params, feats):
    """Under a CPU profiler each record the run made has its two markers
    among the run's host events, the start marker before the end marker,
    both inside the enclosing range, in the order of the records, and
    none is a device event."""
    last = max((r.id for r in timing.records()), default=0)
    events = _profiled(lambda: decode(params, CFG, feats, _options()))
    recs = [r for r in timing.records() if r.id > last]
    outer = next(e for e in events if e.name == "outer")
    marks = {}
    for e in events:
        m = timing.parse_marker(e.name)
        if m is not None:
            assert e.device_type == torch.autograd.DeviceType.CPU
            assert outer.time_range.start <= e.time_range.start
            assert e.time_range.end <= outer.time_range.end
            marks[(m[1], m[2])] = (m[0], e.time_range.start)
    assert len(marks) == 2 * len(recs)
    for r in recs:
        name, start = marks[(r.id, False)]
        _, end = marks[(r.id, True)]
        assert name == r.name and start <= end
    starts = [marks[(r.id, False)][1] for r in recs]
    assert starts == sorted(starts)
    root = recs[0]
    for r in recs[1:]:  # children inside their parent on this clock too
        assert marks[(root.id, False)][1] <= marks[(r.id, False)][1]
        assert marks[(r.id, True)][1] <= marks[(root.id, True)][1]


def test_marker_names_round_trip():
    assert timing.parse_marker(timing.marker("decode.step", 17, False)) == \
        ("decode.step", 17, False)
    assert timing.parse_marker(timing.marker("a#b", 3, True)) == ("a#b", 3, True)
    for other in ("aten::mm", "span:x#[", "span:#3]", "span:x#3", "bench.decode"):
        assert timing.parse_marker(other) is None


def test_train_profile_dir_trace_holds_the_spans(tmp_path):
    """``train(profile_dir=...)`` profiles steps 10-15: its Chrome trace
    holds each of those steps' forward, backward and optimizer markers,
    as host events with the profiler's timestamps."""
    data = write_dataset(str(tmp_path / "ds"), n=4, seconds=0.3)
    train(model_name="test-tiny", train_data_path=data, test_data_path=data,
          output_dir=str(tmp_path / "run"), num_steps=16, batch_size=2,
          validate_every=100, save_every=100, final_validate=False,
          profile_dir=str(tmp_path / "prof"), device="cpu")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    seen = {}
    for e in trace["traceEvents"]:
        m = timing.parse_marker(e.get("name", ""))
        if m is not None:
            assert e.get("cat") != "gpu_user_annotation"
            seen.setdefault(m[0], []).append(e["ts"])
    assert set(seen) == {"train.step"} | set(TRAIN_CHILDREN)
    counts = {len(v) for v in seen.values()}
    assert len(counts) == 1 and counts.pop() % 2 == 0
