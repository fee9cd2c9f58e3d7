"""The harness is driven by data: a later change adds a cell or a metric
by adding files, and edits none. BENCHMARK.json and the files agree."""

import hashlib
import json
import shutil
from pathlib import Path

from benchmark.harness import registry
from benchmark.harness.trace import Stretch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NEW_METRIC = '''"""A metric added later: the chunk's steps a second."""
LAYER = "training step (train.step, train.optimizer)"
UNIT = "steps/s"
SOURCE = "program_span"
MOVES = "train_samples_per_s"
BETTER = "higher"


def read(facts):
    t = facts.get("spans", {}).get("chunk")
    return len(t) * facts["chunk"] / sum(t) if t else None
'''


def _hashes(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_found_by_adding_files(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(copy)
    (copy / "traffic" / "finetune-32.json").write_text(json.dumps(
        dict(json.loads((copy / "traffic" / "finetune-64.json").read_text()), batch=32)))
    (copy / "workloads" / "small.finetune-b32.json").write_text(json.dumps(
        {"config": "whisper-small", "traffic": "finetune-32", "chips": 1,
         "limits": {"loss_gap": 1.0}}))
    (copy / "metrics" / "steps_per_s.train.py").write_text(NEW_METRIC)

    assert "small.finetune-b32" in registry.cell_names(copy)
    cell = registry.cell("small.finetune-b32", copy)
    assert cell["mix"]["batch"] == 32 and cell["config_file"]["d_model"] == 768
    assert registry.e2e(cell, copy) == {"train_samples_per_s": ("train_samples_per_s",
                                                                "samples/s")}
    assert "steps_per_s.train" in registry.metric_names(copy)
    facts = {"spans": {"chunk": [2.0, 2.0]}, "chunk": 8, "stretch": Stretch(), "walls": []}
    got = registry.read_metrics(facts, ["train_samples_per_s"], copy)
    assert got["steps_per_s.train"] == {"value": 4.0, "unit": "steps/s"}
    assert "step_ms.train" in got
    after = _hashes(copy)
    assert {k: after[k] for k in before} == before
    assert len(after) == len(before) + 3


def test_benchmark_json_agrees_with_the_files():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"] == []
    drivers = {}
    for w in spec["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["config"] == w["config"] and w["config"] in configs
        assert cell["traffic"] == w["traffic"] and cell["chips"] == w["chips"] == 1
        drivers[w["name"]] = registry.e2e(cell)
    assert set(drivers) == set(registry.cell_names())
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for name, m in e2e.items():
        if name != "setup_s":
            assert set(m["workloads"]) == {c for c, moves in drivers.items() if name in moves}
            units = {moves[name][1] for moves in drivers.values() if name in moves}
            assert units == {m["unit"]}, name
    assert set(e2e) == {"setup_s"} | {n for moves in drivers.values() for n in moves}
    listed = {m["name"]: m for m in spec["per_layer"]}
    assert set(listed) == set(registry.metric_names())
    for name, m in listed.items():
        mod = registry.metric(name)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.BETTER) == \
            (m["layer"], m["unit"], m["source"], m["moves"], m["better"]), name
        assert set(m["workloads"]) == {c for c, moves in drivers.items() if mod.MOVES in moves}
    # every cell reports at least one per-layer metric
    assert {c for m in listed.values() for c in m["workloads"]} == set(drivers)
