"""On the card: each cell at its own size comes out correct on a short run,
and its control (the plain reference in the program's place, one
precision below the configuration's) comes out not correct. Skips where
there is no card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("sasrec.b512", "granite-moe.b64", "sasrec.b16k")


def _result(cell, seed, *extra):
    r = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "3", "--trace", "0", *extra], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    _need_card()
    out = _result(cell, 2 ** 31 + 101)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    _need_card()
    out = _result(cell, 2 ** 31 + 202, "--control", "1")
    assert not out["correct"]
    err = out["checks"]["tower_rel_err"]
    assert err["value"] > err["limit"]
