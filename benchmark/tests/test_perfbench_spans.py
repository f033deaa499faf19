"""The device's work put down to the program's spans, on synthetic traces
whose events carry correlation ids."""

import importlib.util
import pathlib

import pytest

from harness import spans, trace
from test_perfbench_trace import EVENTS, MS, Event, UntypedEvent


class Linked(Event):
    """A kineto event with a correlation id."""

    def __init__(self, kind, name, start, duration, correlation=0):
        super().__init__(kind, name, start, duration)
        self.correlation = correlation

    def correlation_id(self):
        return self.correlation


class UntypedLinked(UntypedEvent, Linked):
    pass


def call(t, correlation, name="cudaLaunchKernel"):
    """The runtime call, on whichever thread, at ``t`` ms."""
    return ("cuda_runtime", name, t * MS, MS // 100, correlation)


STEP = [
    ("user_annotation", "bench.step", 0, 40 * MS),
    ("user_annotation", "train.forward", 0, 10 * MS),
    ("user_annotation", "op.sgcn_fwd", 2 * MS, 2 * MS),
    call(2.5, 1),
    ("kernel", "mma_fwd_kernel<true>", 5 * MS, 3 * MS, 1),
    call(3, 2),  # the channel sums the entry point launches after it
    ("kernel", "channel_sums::kernel(float const*)", 8 * MS, MS, 2),
    call(6, 3),
    ("kernel", "at::native::add", 9 * MS, 2 * MS, 3),
    # the main thread waits in train.backward; autograd's thread launches
    ("user_annotation", "train.backward", 10 * MS, 20 * MS),
    ("user_annotation", "op.sgcn_bwd", 12 * MS, 2 * MS),
    call(13, 4),
    ("kernel", "mma_dx_kernel", 14 * MS, 4 * MS, 4),
    call(20, 5, "cudaMemcpyAsync"),
    ("gpu_memcpy", "Memcpy DtoD", 20 * MS, MS, 5),
    ("user_annotation", "train.optimizer", 30 * MS, 5 * MS),
    call(31, 6, "cudaMemsetAsync"),
    ("gpu_memset", "Memset (Device)", 31 * MS, MS, 6),
    ("user_annotation", "train.metrics", 35 * MS, MS),
    call(35.5, 7),
    ("kernel", "argmax", 36 * MS, MS, 7),
    # a host operator whose id happens to be a runtime call's: not a call
    ("cpu_op", "aten::add", 45 * MS, MS, 3),
    call(50, 8),  # outside every span
    ("kernel", "after the step", 50 * MS, MS, 8),
    ("kernel", "no runtime call", 52 * MS, 2 * MS, 99),
    # a range's shadow on the device is no work
    ("gpu_user_annotation", "train.forward", 5 * MS, 6 * MS, 1),
]


def events(cls=Linked):
    return [cls(*e) for e in STEP]


def test_work_goes_to_the_spans_that_held_its_runtime_call():
    out = spans.attribute(*spans.assign(events()))
    s = out["spans"]
    assert s["train.forward"]["device_s"] == pytest.approx(6e-3)
    assert s["train.forward"]["work"] == 3
    # channel_sums belongs to the entry point that launched it
    assert s["op.sgcn_fwd"]["device_s"] == pytest.approx(4e-3)
    assert s["op.sgcn_fwd"]["work"] == 2
    # launched from another thread while the main thread was in backward
    assert s["train.backward"]["device_s"] == pytest.approx(5e-3)
    assert s["op.sgcn_bwd"]["device_s"] == pytest.approx(4e-3)
    assert s["train.optimizer"]["device_s"] == pytest.approx(1e-3)
    assert s["train.metrics"]["work"] == 1
    assert "bench.step" not in s
    # the item after the step and the one whose call the trace lacks
    assert out["unattributed_s"] == pytest.approx(3e-3)
    assert out["unattributed_work"] == 2


def test_host_seconds_and_counts_of_each_span():
    s = spans.attribute(*spans.assign(events()))["spans"]
    assert s["train.backward"]["host_s"] == pytest.approx(20e-3)
    assert s["op.sgcn_fwd"]["host_s"] == pytest.approx(2e-3)
    assert all(v["count"] == 1 for v in s.values())


def test_runtime_calls_of_builds_without_activity_types():
    """There the runtime's calls show as host operators named cu*."""
    want = spans.attribute(*spans.assign(events()))
    got = spans.attribute(*spans.assign(events(UntypedLinked)))
    assert got["spans"].keys() == want["spans"].keys()
    for name, s in want["spans"].items():
        assert got["spans"][name] == pytest.approx(s)
    assert got["unattributed_s"] == pytest.approx(want["unattributed_s"])


def test_events_without_correlation_ids_leave_all_unattributed():
    items, program = spans.assign(EVENTS)
    out = spans.attribute(items, program)
    assert program == [] and out["spans"] == {}
    assert out["unattributed_work"] == trace.reduce(EVENTS, 0.1)[
        "device_work"]
    assert all(owners == () for _, _, owners in items)


def test_the_innermost_span_holds_a_call():
    family = spans.Family([(0, 100, "outer"), (10, 20, "inner"),
                           (30, 40, "later")])
    assert family.holding(15) == "inner"
    assert family.holding(25) == "outer"
    assert family.holding(35) == "later"
    assert family.holding(150) is None
    assert spans.Family([]).holding(5) is None


TINY = {
    "stgcn_train_b128_bf16": {"config": {"frames": 12}, "params": {
        "batch": 2, "pool": 2, "check_steps": 1, "warmup_steps": 0}},
    "stgcn_serve_folded_bf16_r64": {"config": {"frames": 12}, "params": {
        "request": 2, "pool": 2, "warmup_requests": 1}},
}


@pytest.mark.parametrize("cell,phases", [
    ("stgcn_train_b128_bf16", ["train.backward", "train.forward",
                               "train.metrics", "train.optimizer"]),
    ("stgcn_serve_folded_bf16_r64", ["serve.forward", "serve.input",
                                     "serve.output"]),
])
def test_the_split_of_a_cell_on_the_cpu(cell, phases):
    """``scripts/torch_span_split.py`` at a tiny size on the CPU: each of
    the cell's phases once a unit, and no device work to put down."""
    path = pathlib.Path(__file__).resolve().parents[2] / "scripts" / \
        "torch_span_split.py"
    spec = importlib.util.spec_from_file_location("torch_span_split", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.split(cell, 2147483659, 0.2, "cpu", TINY[cell])
    assert out["device"] == "cpu" and out["units"] >= 1
    assert sorted(out["spans"]) == phases
    assert all(s["count"] == 1 and s["device_ms"] == 0
               for s in out["spans"].values())
    assert out["launches_per_unit"] == 0
    assert out["unattributed_share_of_busy"] is None
