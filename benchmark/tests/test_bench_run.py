"""The entry point refuses to print a result where it cannot measure: on a
machine without a CUDA card, and in a directory that holds the benchmark
alone, without the program."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "unet256.train.b8", "--seed", str(2**31 + 1),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode == run.EXIT_NO_CARD
    assert proc.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run(tmp_path)
    assert proc.returncode == run.EXIT_NO_PROGRAM
    assert proc.stdout.strip() == ""
