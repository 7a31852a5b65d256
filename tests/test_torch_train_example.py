"""The port's training entry point, ``python -m
torchmpi_tpu_torch.examples.train_llama``, end to end on the CPU: the loss
falls over 8 SGD steps and generation after training prints its legality
line."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_train_example_learns_and_generates_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.examples.train_llama",
         "--device", "cpu", "--steps", "8", "--generate", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    trained = [ln for ln in lines if ln.startswith("trained 8 steps")]
    assert trained, res.stdout
    first, last = (float(x) for x in trained[0].split("loss ")[1].split(
        " -> "))
    assert last < first
    assert any(ln.startswith("generation legality:") for ln in lines)
