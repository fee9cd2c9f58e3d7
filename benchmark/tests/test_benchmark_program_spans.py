"""The readers of the program's spans (``metrics/_program.py``) on
hand-made records and a hand-made stretch: the means take only the spans
whose record and both markers the stretch holds, the idle share counts
the device's gaps while the host is inside ``decode.step``, and every
reader finds nothing without records, without markers, without a
stretch, or in a program without spans."""

import pytest

from benchmark.harness import registry
from benchmark.harness.trace import Stretch
from whisper_ipa_torch.utils import timing

DECODE = {"cache_init_ms": 5.0, "step_host_ms": 2.5, "step_stream_ms": 5.0,
          "step_idle_pct": 100.0 * 400 / 620}
TRAIN = {"forward_ms.train": 20.0, "backward_ms.train": 40.0,
         "optimizer_ms.train": 60.0}
NEW = [f"{m}.{s}" for m in DECODE for s in ("eval", "words", "large")] + list(TRAIN)


def _rec(name, rid, host_ms=1.0, stream=(0.0, 1.0), parent=None):
    return timing.SpanRecord(name, rid, parent, parent or rid, 10.0, 10.0 + host_ms / 1e3,
                             stream[0], stream[1])


RECORDS = [
    _rec("decode", 1, stream=(0.0, 30.0)),
    _rec("decode.init_cache", 2, stream=(0.0, 5.0), parent=1),
    _rec("decode.step", 3, host_ms=2.0, stream=(10.0, 14.0), parent=1),
    _rec("decode.step", 4, host_ms=3.0, stream=(14.0, 20.0), parent=1),
    _rec("decode.init_cache", 9, stream=(0.0, 100.0)),  # made outside the stretch
    _rec("train.forward", 5, stream=(0.0, 30.0)),
    _rec("train.backward", 6, stream=(30.0, 90.0)),
    _rec("train.optimizer", 7, stream=(90.0, 180.0)),
    _rec("train.forward", 10, stream=(0.0, 10.0)),
    _rec("train.backward", 11, stream=(10.0, 30.0)),
    _rec("train.optimizer", 12, stream=(30.0, 60.0)),
    _rec("train.optimizer", 13, stream=(0.0, 999.0)),  # its end marker is missing
]


def _marks(name, rid, start, end):
    """A span's two markers: empty ranges of 1 us at its start and end."""
    return [(timing.marker(name, rid, False), start, start + 1),
            (timing.marker(name, rid, True), end - 1, end)]


def _stretch():
    st = Stretch()
    st.spans = [("decode", 0.0, 1000.0)]
    # device busy 0-150, 450-480, 800-1000: gaps 150-450 and 480-800 (620 us)
    st.device = [("k", 0.0, 150.0), ("k", 450.0, 480.0), ("k", 800.0, 1000.0)]
    st.host = [("aten::mm", 5.0, 60.0)]
    st.host += _marks("decode", 1, 0.0, 1000.0)
    st.host += _marks("decode.init_cache", 2, 10.0, 100.0)
    st.host += _marks("decode.step", 3, 200.0, 400.0)  # 200 us of the first gap
    st.host += _marks("decode.step", 4, 500.0, 700.0)  # 200 us of the second
    for rid, name in [(5, "train.forward"), (6, "train.backward"), (7, "train.optimizer"),
                      (10, "train.forward"), (11, "train.backward"),
                      (12, "train.optimizer")]:
        st.host += _marks(name, rid, 10.0 * rid, 10.0 * rid + 5)
    st.host.append((timing.marker("train.optimizer", 13, False), 900.0, 901.0))
    return st


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(timing, "records", lambda: list(RECORDS))


def _read(name, facts):
    return registry.metric(name).read(facts)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_its_value(name, recorded):
    want = TRAIN.get(name) or DECODE[name.rsplit(".", 1)[0]]
    assert _read(name, {"stretch": _stretch()}) == pytest.approx(want)


def test_the_idle_share_is_zero_where_the_device_never_idles(recorded):
    st = _stretch()
    st.device = [("k", 0.0, 1000.0)]
    assert _read("step_idle_pct.eval", {"stretch": st}) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_without_records(name, monkeypatch):
    facts = {"stretch": _stretch()}
    monkeypatch.setattr(timing, "records", lambda: [])
    assert _read(name, facts) is None
    monkeypatch.setattr(timing, "records", lambda: list(RECORDS))
    for empty in ({"stretch": None}, {"stretch": Stretch()}, {}):
        assert _read(name, empty) is None
    bare = _stretch()
    bare.host = [h for h in bare.host if not timing.parse_marker(h[0])]
    assert _read(name, {"stretch": bare}) is None
    monkeypatch.delattr(timing, "records")  # a program without spans
    assert _read(name, facts) is None


def test_the_new_readers_are_listed_with_their_layers():
    for name in NEW:
        mod = registry.metric(name)
        assert mod.SOURCE == "program_span" and mod.BETTER == "lower"
        assert mod.LAYER == ("training step (train.step, train.optimizer)"
                             if name.endswith(".train") else "decode loop (decode.decoding)")
