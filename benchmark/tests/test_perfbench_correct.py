"""What decides ``correct`` fails where it should: a run with the timed path
broken underneath, driven on the CPU at a small size without the harness's
look for a card, comes out not correct, once for each fault a cell can
have; and the control, the reference computed in the lower precision in
the program's place, reads above a limit of the cells it separates."""

import sys
import time

import pytest
import torch

from harness import compare, manifest, runner

sys.path.insert(0, str(manifest.BENCH_DIR))
import calibrate  # noqa: E402

SMALL = {
    "stgcn_train_b128_bf16": {"config": {"frames": 16},
                              "params": {"batch": 16, "pool": 4,
                                         "warmup_steps": 0}},
    "stgcn_serve_folded_bf16_r64": {
        "config": {"frames": 16},
        "params": {"request": 4, "pool": 2, "warmup_requests": 1}},
    "vradar_train_b64_unfrozen": {
        "config": {"frames": 20, "upsample": 16, "image": 64},
        "params": {"batch": 4, "pool": 3, "warmup_steps": 0}},
    "vradar_train_b64_frozen": {
        "config": {"frames": 20, "upsample": 16, "image": 64},
        "params": {"batch": 4, "pool": 3, "warmup_steps": 0}},
}
TRAIN = [c for c in SMALL if manifest.workload(c)["driver"] == "train_closed"]
FAULTS = [(c, f) for c in TRAIN for f in ("unchanged", "half_batch")] + [
    ("stgcn_serve_folded_bf16_r64", "altered_answer")]
# the control of each cell whose numbers it fails. On the spectrogram
# cells (not in BENCHMARK.json) no lower precision (TF32 in the radar,
# bfloat16 in the ResNet) reads above the sound program: the program's
# float32 radar phase moves every number they compare as much (PERF.md,
# Open questions)
CONTROL = {"stgcn_train_b128_bf16": "fp8",
           "stgcn_serve_folded_bf16_r64": "fp8"}


def run(cell, monkeypatch, fault=None):
    builder = manifest.module("models", manifest.workload(cell)["config"])
    if fault:
        for name in ("build_train", "build_predictor"):
            if hasattr(builder, name):
                monkeypatch.setattr(builder, name, getattr(builder, name))
        calibrate.plant(builder, fault)
    return runner.run_cell(cell, 2147483659, 0.3, False, time.perf_counter(),
                           "cpu", SMALL[cell])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    result = run(cell, monkeypatch, fault)
    assert result["correct"] is False, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", list(CONTROL))
def test_the_control_is_not_correct(cell):
    c = runner.Cell(cell, 2147483659, "cpu", SMALL[cell])
    runner.set_precision(c.params)
    driver = manifest.module("drivers", c.workload["driver"])
    session = driver.setup(c)
    if session.unit == "request":
        session.window(0.2, False)
    session.release()
    numbers, _ = calibrate.numbers_of(driver, session, "control",
                                      CONTROL[cell])
    assert any(numbers[k] > limit for k, limit in c.limits.items()), numbers


def test_grad_diff_sees_a_direction_that_the_norms_miss():
    """A gradient of the same norm in another direction (a step over part
    of the batch keeps its norm within a few percent) passes the gaps of
    norms and not the gap of the difference."""
    g = torch.Generator().manual_seed(0)
    want = {f"leaf{i}": torch.randn(64, generator=g) for i in range(5)}
    got = {k: v.roll(1) for k, v in want.items()}

    def readings(grads):
        return {"losses": [1.0], "grad_tensors": grads,
                "grads": {k: v.norm().item() for k, v in grads.items()},
                "deltas": {k: 1.0 for k in grads}}

    numbers = compare.training_numbers(readings(got), readings(want))
    assert numbers["grad_gap"] == pytest.approx(0.0, abs=1e-6)
    assert numbers["grad_diff"] > 1.0
    same = compare.training_numbers(readings(want), readings(want))
    assert same["grad_diff"] == 0.0
    del got["leaf0"]  # a leaf the program did not report
    assert compare.leaf_diffs(got, want, readings(want)["grads"],
                              ["leaf0"])["leaf0"] == float("inf")
