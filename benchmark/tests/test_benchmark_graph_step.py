"""The reader of the decode loop's graph share (``metrics/_graph.py``) on
hand-made records and a hand-made stretch: it counts the
``decode.replay`` spans over the ``decode.step`` spans whose record and
both markers the stretch holds, and finds nothing in a program that never
replays, without records, without markers or without a stretch."""

import pytest

from benchmark.harness import registry
from benchmark.harness.trace import Stretch
from whisper_ipa_torch.utils import timing

NAMES = [f"graph_step_pct.{s}" for s in ("eval", "words", "large")]


def _rec(name, rid, parent):
    return timing.SpanRecord(name, rid, parent, 1, 10.0, 10.001, 0.0, 1.0)


def _marks(name, rid, start, end):
    return [(timing.marker(name, rid, False), start, start + 1),
            (timing.marker(name, rid, True), end - 1, end)]


def _recorded(replays: int):
    """One decode call of eight steps, the first ``replays`` after the first
    step each holding a replay, and a ninth step whose end marker is
    missing: (records, stretch)."""
    recs = [_rec("decode", 1, None), _rec("decode.capture", 2, 1)]
    st = Stretch()
    st.spans = [("decode", 0.0, 1000.0)]
    st.device = [("k", 0.0, 1000.0)]
    st.host = _marks("decode", 1, 0.0, 1000.0) + _marks("decode.capture", 2, 5.0, 9.0)
    for i in range(8):
        sid, t = 10 + 2 * i, 10.0 + 100 * i
        recs.append(_rec("decode.step", sid, 1))
        st.host += _marks("decode.step", sid, t, t + 90)
        if 1 <= i <= replays:
            recs.append(_rec("decode.replay", sid + 1, sid))
            st.host += _marks("decode.replay", sid + 1, t + 10, t + 20)
    recs.append(_rec("decode.step", 99, 1))
    st.host.append((timing.marker("decode.step", 99, False), 950.0, 951.0))
    return recs, st


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("replays,want", [(6, 75.0), (1, 12.5)])
def test_the_share_of_steps_that_replay(name, replays, want, monkeypatch):
    recs, st = _recorded(replays)
    monkeypatch.setattr(timing, "records", lambda: list(recs))
    assert registry.metric(name).read({"stretch": st}) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_without_replays(name, monkeypatch):
    """The eager loop, and a commit before the graph path, record steps
    and no replay; no records, no markers, no stretch, no spans at all."""
    mod = registry.metric(name)
    recs, st = _recorded(0)
    monkeypatch.setattr(timing, "records", lambda: list(recs))
    assert mod.read({"stretch": st}) is None
    recs, st = _recorded(6)
    for empty in ({"stretch": None}, {"stretch": Stretch()}, {}):
        assert mod.read(empty) is None
    bare = Stretch(spans=st.spans, device=st.device)
    assert mod.read({"stretch": bare}) is None
    monkeypatch.setattr(timing, "records", lambda: [])
    assert mod.read({"stretch": st}) is None
    monkeypatch.delattr(timing, "records")
    assert mod.read({"stretch": st}) is None


def test_the_readers_are_listed_with_their_layer():
    moves = {"eval": "audio_s_per_s", "words": "audio_s_per_s.words",
             "large": "audio_s_per_s.large"}
    for name in NAMES:
        mod = registry.metric(name)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.BETTER) == (
            "decode loop (decode.decoding)", "%", "program_span", "higher")
        assert mod.MOVES == moves[name.rsplit(".", 1)[1]]
