"""The benchmark's data-parallel training driver
(``benchmark/drivers/train_ddp.py``, the four-card cell's) on the CPU: two
gloo ranks at a small ST-GCN, rank 0 in this process and rank 1 started by
the driver, as on the card. The ranks take the same steps and agree on the
count, rank 0's readings match the reference's step over both ranks'
batches, a rank that never joins fails the set-up within the timeout, and
a rank that dies fails the window at once."""

import pathlib
import subprocess
import sys
import textwrap
import time

import pytest
import torch

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))

from harness import manifest, runner  # noqa: E402

DRIVER = manifest.module("drivers", "train_ddp")
CELL = "stgcn_train_ddp4_bf16"
TIMEOUT_S = 20


def small(**params):
    return {"config": {"frames": 12},
            "params": {"batch": 2, "pool": 2, "check_steps": 2,
                       "warmup_steps": 1, "ranks": 2, "backend": "gloo",
                       "timeout_s": TIMEOUT_S, **params}}


def cell(**params):
    c = runner.Cell(CELL, 2147483659, "cpu", small(**params))
    runner.set_precision(c.params)
    return c


def test_ranks_take_the_same_steps_and_match_the_global_step():
    session = DRIVER.setup(cell())
    try:
        record = session.window(0.5, False)
    finally:
        session.release()
    assert record["count"] >= 1
    assert record["clips"] == record["count"] * 2 * 2
    assert all(p.returncode == 0 for p in session.children)
    numbers = session.check()
    limits = manifest.workload(CELL)["limits"]
    assert all(numbers[k] <= v for k, v in limits.items()), numbers


def test_a_missing_rank_fails_the_setup_within_the_timeout():
    """Rank 1 never starts: rank 0's join gives up after the timeout (in a
    process of its own, which the failed join leaves behind)."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(BENCH_DIR.parent)!r}, {str(BENCH_DIR)!r}]
        from harness import manifest, runner
        driver = manifest.module("drivers", "train_ddp")
        driver.spawn = lambda cell, init_method: []
        c = runner.Cell({CELL!r}, 5, "cpu", {small()!r})
        start = time.perf_counter()
        try:
            driver.setup(c)
        except Exception:
            print("failed after", time.perf_counter() - start)
        """)
    start = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=TIMEOUT_S + 120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[:2] == ["failed", "after"], out.stdout
    assert float(out.stdout.split()[-1]) < TIMEOUT_S + 30
    assert time.perf_counter() - start < TIMEOUT_S + 120


def test_a_rank_that_dies_fails_the_window():
    session = DRIVER.setup(cell())
    try:
        for p in session.children:
            p.kill()
            p.wait()
        start = time.perf_counter()
        with pytest.raises(RuntimeError, match="ended during the window"):
            session.window(5.0, False)
        assert time.perf_counter() - start < 5.0
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
