"""The benchmark's boundaries: nothing it runs imports JAX or the JAX
package, the reference imports nothing of the program, nothing reads the
old JAX-era benchmark files, and a run without a card exits non-zero with
no result."""
import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "out" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & FORBIDDEN, roots


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] in {"__future__", "typing", "numpy",
                                      "torch", "math", "bench"}, name
        if name.startswith("bench"):
            assert name.startswith("bench.reference"), name


def test_nothing_reads_the_old_benchmark_files():
    old = ("bench" + "marks/", "BENCH" + "_")
    for path in FILES:
        text = path.read_text()
        assert not any(o in text for o in old), path


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "sasrec.b512",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_no_card_exits_nonzero_with_no_result():
    r = _run(ROOT)
    assert r.returncode != 0
    assert not _has_result(r.stdout)
    assert "CUDA" in r.stderr


def test_run_names_loaded_jax_modules_by_whole_top_level_name():
    spec = importlib.util.spec_from_file_location("bench_run_script",
                                                  BENCH / "run.py")
    bench_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_run)
    assert bench_run.forbidden(["jax.numpy", "repro_torch.core.cache",
                                "repro.core", "flax", "os"]) == {
        "jax", "repro", "flax"}
    assert bench_run.forbidden(["repro_torch", "jaxtyping"]) == set()
