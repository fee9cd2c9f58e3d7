"""On the card: one short run of a cell through ``run.py`` prints a
correct result that names the card. Skips without a CUDA card; run on
the chip with ``python -m pytest benchmark/tests -m cuda``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_is_correct(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card only")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "small.eval-words",
         "--seed", "3000000777", "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0
        assert "k2_roofline.words" in result["metrics"]
    else:
        assert result["metrics"]["audio_s_per_s.words"]["value"] > 0
