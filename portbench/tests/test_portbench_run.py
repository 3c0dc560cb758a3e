"""``run.py`` fails without a CUDA device and prints no result."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the check of its absence cannot run here")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr
