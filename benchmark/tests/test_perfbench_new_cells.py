"""The cells ``ctrgcn_train_b128_t64_bf16`` and ``stgcn_train_ddp4_bf16``
(whose files stay under ``benchmark/``, the cell out of ``BENCHMARK.json``
while its runs spread too widely) on the CPU at a small size, without the
harness's look for cards: a sound
run is correct; each fault a cell can have (the optimizer's step a no-op,
half the batch, and each mechanism's own: CTR-GCN's refinement dropped,
the data-parallel gradients left unsummed on rank 0) and the control (the
reference in fp8 in the program's place) are not. Also the aggregation's
work counts and the cell's shapes, and the configuration against the
published model's count of operations."""

import sys
import time

import pytest

import chip_smoke
from harness import manifest, runner

sys.path.insert(0, str(manifest.BENCH_DIR))
import calibrate  # noqa: E402

CTRGCN = "ctrgcn_train_b128_t64_bf16"
DDP = "stgcn_train_ddp4_bf16"
SEED = 2147483659
SMALL = {
    CTRGCN: {"config": {"frames": 16},
             "params": {"batch": 8, "pool": 4, "warmup_steps": 0}},
    DDP: {"config": {"frames": 12},
          "params": {"batch": 2, "pool": 2, "warmup_steps": 0,
                     "check_steps": 2, "ranks": 2, "backend": "gloo",
                     "timeout_s": 60}},
}
COUNTS = manifest.module("counts", "ctrgc")


def run(cell, monkeypatch, fault=None, params=None):
    overrides = {k: dict(v) for k, v in SMALL[cell].items()}
    overrides["params"].update(params or {})
    if fault:
        builder = manifest.module("models", manifest.workload(cell)["config"])
        monkeypatch.setattr(builder, "build_train", builder.build_train)
        calibrate.plant(builder, fault)
    return runner.run_cell(cell, SEED, 0.3, False, time.perf_counter(),
                           "cpu", overrides)


@pytest.mark.parametrize("cell", [CTRGCN, DDP])
def test_a_sound_run_is_correct(cell, monkeypatch):
    result = run(cell, monkeypatch)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == set(manifest.workload(cell)["limits"])
    listed = [w["name"] for w in manifest.manifest()["workloads"]]
    assert ("train_clips_per_s" in result["metrics"]) == (cell in listed)


@pytest.mark.parametrize("cell,fault,params", [
    (CTRGCN, "unchanged", None), (CTRGCN, "half_batch", None),
    (CTRGCN, None, {"fault": "no_refinement"}),
    (DDP, None, {"fault": "local_gradients"}),
])
def test_a_fault_is_not_correct(cell, fault, params, monkeypatch):
    result = run(cell, monkeypatch, fault, params)
    assert result["correct"] is False, result["checks"]


def test_the_control_is_not_correct():
    c = runner.Cell(CTRGCN, SEED, "cpu", SMALL[CTRGCN])
    runner.set_precision(c.params)
    driver = manifest.module("drivers", c.workload["driver"])
    session = driver.setup(c)
    session.release()
    numbers, _ = calibrate.numbers_of(driver, session, "control", "fp8")
    assert any(numbers[k] > limit for k, limit in c.limits.items()), numbers


@pytest.mark.parametrize("backward", [False, True])
def test_ctrgc_counts_match_chip_smoke(backward):
    """The counts' operations and bytes at the cell's shapes are the ones
    ``chip_smoke.py``'s ``ctrgc_kernel`` phase bounds them by."""
    for (c, t), _ in chip_smoke.CTRGC_SHAPES:
        shape = dict(n=chip_smoke.CTRGC_NM, k=3, c=c, t=t, v=25,
                     act="bfloat16")
        ops, nbytes = (COUNTS.bwd if backward else COUNTS.fwd)(**shape)
        fwd_ops = 2 * 3 * chip_smoke.CTRGC_NM * c * t * 25 * 25
        assert ops == (2 * fwd_ops if backward else fwd_ops)
        x3, s = chip_smoke.CTRGC_NM * 3 * c * t * 25 * 2, (
            chip_smoke.CTRGC_NM * 3 * c * 25 * 25 * 4)
        z = chip_smoke.CTRGC_NM * c * t * 25 * 2
        assert nbytes == (z + 2 * x3 + 2 * s if backward else x3 + s + z)


def test_cell_shapes_are_the_ten_blocks():
    config = {"name": "ctrgcn_ntu60", **manifest.config("ctrgcn_ntu60")}
    params = manifest.workload(CTRGCN)["params"]
    shapes = manifest.module("models", "ctrgcn_ntu60").op_shapes(config,
                                                                 params)
    got = [(s["c"], s["t"]) for s in shapes["ctrgc"]]
    assert got == [s for s, n in chip_smoke.CTRGC_SHAPES for _ in range(n)]
    assert all(s["n"] == chip_smoke.CTRGC_NM and s["dtype"] == "float32"
               and s["act"] == "bfloat16" for s in shapes["ctrgc"])


def test_operations_match_the_published_count():
    """A clip's forward is 3.88 GFLOP: 1.94 G multiply-adds, against the
    paper's 1.97 G."""
    reference = manifest.module("reference", "ctrgcn_ntu60")
    config = {"name": "ctrgcn_ntu60", **manifest.config("ctrgcn_ntu60")}
    assert reference.flops(config, 1, False) == pytest.approx(3.878e9,
                                                              rel=1e-3)
