"""Nothing under benchmark/ imports JAX or the JAX package, the reference
imports nothing of the program, and a run without a card, or without the
program beside it, prints no result and exits non-zero."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness import cli

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "whisper_ipa_tpu"}


def _imports(path: Path):
    """Top-level names of every module the file imports."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = set(_imports(f)) & FORBIDDEN
        assert not bad, f"{f} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = set(_imports(f))
        assert "whisper_ipa_torch" not in names, f
        assert names <= {"__future__", "functools", "math", "typing", "numpy", "torch",
                         "benchmark"}, (f, names)
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                    node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), (f, node.module)


def test_the_guard_names_loaded_jax_modules(monkeypatch):
    assert cli.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "whisper_ipa_tpu_extra", sys)
    assert cli.forbidden_modules() == ["jax"]


def _run(cwd, *extra_env):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "small.eval-words",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            json.loads(line)
            return False
        except ValueError:
            pass
    return True


def test_run_without_a_card_prints_no_result_and_fails():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert _no_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run(tmp_path)
    assert proc.returncode != 0 and _no_result(proc.stdout)
    # past the card's check the program is missing
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from benchmark.harness import registry, cli;"
            "cli.run_cell(registry.cell('small.eval-words'), 1, 1.0, False,"
            " torch.device('cpu'), 'cpu', time.time())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and _no_result(proc.stdout)
    assert "whisper_ipa_torch" in proc.stderr
