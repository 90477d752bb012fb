"""Each cell run once on the card, as the driver runs it: exit 0 and
``correct``.  Needs a CUDA card; run with ``python -m pytest -m cuda
portbench/``."""

import json
import subprocess
import sys

import pytest

from portbench.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           "4242424242", "--seconds", "3", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
