"""Finds everything by name, so that a cell, a configuration, a traffic mix
or a per-layer metric is added by adding files:

  workloads/<cell>.json    the cell: its configuration, traffic mix,
                           chips, the limits of its comparison and, in
                           ``report_as``, the names under which it
                           reports its driver's end-to-end quantities
  configs/<config>.json    the model's published sizes, as run
  traffic/<mix>.json       the traffic mix's parameters and its ``kind``
  traffic/<kind>.py        the driver of a kind of traffic
  metrics/<metric>.py      the reader of one per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parents[1]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, prefix: str) -> ModuleType:
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_names(root: Path = BENCH_DIR) -> List[str]:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def metric_names(root: Path = BENCH_DIR) -> List[str]:
    return sorted(p.stem for p in (root / "metrics").glob("*.py")
                  if not p.name.startswith("_"))


def cell(name: str, root: Path = BENCH_DIR) -> Dict:
    """The cell with its configuration file and traffic mix resolved."""
    c = _json(root / "workloads" / f"{name}.json")
    return dict(c, name=name,
                config_file=_json(root / "configs" / f"{c['config']}.json"),
                mix=_json(root / "traffic" / f"{c['traffic']}.json"))


def driver(kind: str, root: Path = BENCH_DIR) -> ModuleType:
    return _module(root / "traffic" / f"{kind}.py", "benchmark_traffic_")


def e2e(cell: Dict, root: Path = BENCH_DIR) -> Dict[str, Tuple[str, str]]:
    """The cell's end-to-end metrics: {name: (quantity, unit)}. Each
    quantity its traffic's driver measures (``E2E``: quantity -> unit) is
    reported under its own name, or under the one the cell's
    ``report_as`` gives it, so that cells whose runs spread differently
    can hold a quantity to bounds of their own."""
    names = cell.get("report_as", {})
    return {names.get(q, q): (q, unit)
            for q, unit in driver(cell["mix"]["kind"], root).E2E.items()}


def metric(name: str, root: Path = BENCH_DIR) -> ModuleType:
    return _module(root / "metrics" / f"{name}.py", "benchmark_metric_")


def dims(config_file: Dict) -> Dict[str, int]:
    """The sizes the harness builds from, read from the published keys."""
    c = config_file
    return {
        "d_model": c["d_model"],
        "n_mels": c["num_mel_bins"],
        "encoder_layers": c["encoder_layers"],
        "decoder_layers": c["decoder_layers"],
        "encoder_heads": c["encoder_attention_heads"],
        "decoder_heads": c["decoder_attention_heads"],
        "encoder_ffn": c["encoder_ffn_dim"],
        "decoder_ffn": c["decoder_ffn_dim"],
        "n_vocab": c["vocab_size"],
        "n_audio_ctx": c["max_source_positions"],
        "n_text_ctx": c["max_target_positions"],
    }


def read_metrics(facts: Dict, moves: List[str],
                 root: Path = BENCH_DIR) -> Dict[str, Dict]:
    """Every per-layer metric that moves one of ``moves`` and finds
    something to read in ``facts``: {name: {"value", "unit"}}."""
    out = {}
    for name in metric_names(root):
        mod = metric(name, root)
        if mod.MOVES not in moves:
            continue
        value: Optional[float] = mod.read(facts)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out
