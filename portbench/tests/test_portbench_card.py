"""Each cell end to end on the card, as the benchmark's command runs it,
with a short window. Marked `cuda`: it skips where there is no card.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py -q
"""

import json
import subprocess
import sys

import pytest
import torch

import portbench_tiny


@pytest.mark.cuda
@pytest.mark.parametrize("workload", portbench_tiny.cells())
def test_the_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cmd = [sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(portbench_tiny.SEED),
           "--seconds", "2", "--trace", "0"]
    out = subprocess.run(cmd, cwd=portbench_tiny.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert "setup_s" in line["metrics"]


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cmd = [sys.executable, "portbench/run.py", "--workload", "pathfinder-1080p.review", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=portbench_tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
