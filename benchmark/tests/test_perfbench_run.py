"""``benchmark/run.py`` itself: without a CUDA card it exits non-zero and
prints no result, also in a directory that holds only ``BENCHMARK.json``
and the benchmark's files."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
ARGS = ["--workload", "stgcn_train_b128_bf16", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          capture_output=True, text=True, timeout=300,
                          cwd=cwd)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_no_result():
    out = run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    """One short run of the first cell on the card: correct, with every
    end-to-end metric the manifest gives it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run(ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert {"train_clips_per_s", "peak_mem_gib", "setup_s"} <= set(
        result["metrics"])
