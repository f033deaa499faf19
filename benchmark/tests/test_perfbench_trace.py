"""The traced run's reduction and the metric readers, on synthetic traces."""

import types

import pytest

from harness import manifest, peaks, runner, trace


class Event:
    """A stand-in for a kineto event."""

    def __init__(self, kind, name, start, duration):
        self.kind, self._name = kind, name
        self._start, self._duration = start, duration

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration


MS = 1_000_000  # ns

EVENTS = [
    Event("user_annotation", "bench.window", 0, 100 * MS),
    Event("user_annotation", "bench.step", 0, 50 * MS),
    Event("cpu_op", "aten::add", 1 * MS, 2 * MS),
    Event("cpu_op", "aten::item", 30 * MS, 15 * MS),
    # a range on the device: never busy
    Event("gpu_user_annotation", "bench.step", 0, 100 * MS),
    Event("kernel", "void (anonymous namespace)::mma_fwd::mma_fwd_kernel<"
          "false>(x)", 2 * MS, 10 * MS),
    Event("kernel", "channel_sums::kernel(float const*)", 12 * MS, 2 * MS),
    Event("kernel", "at::native::add", 13 * MS, 5 * MS),  # overlaps
    Event("gpu_memcpy", "Memcpy HtoD", 20 * MS, 5 * MS),
    Event("gpu_memset", "Memset (Device)", 50 * MS, 10 * MS),
    Event("kernel", "channel_sums::kernel(float const*)", 61 * MS, 1 * MS),
]


def test_busy_is_the_union_of_kernels_copies_and_fills():
    t = trace.reduce(EVENTS, window_s=0.1)
    # [2, 18] + [20, 25] + [50, 60] + [61, 62]
    assert t["busy_s"] == pytest.approx((16 + 5 + 10 + 1) * 1e-3)
    assert t["device_work"] == 6
    assert "bench.step" not in t["by_name"]


class UntypedEvent(Event):
    """An event of a torch build whose kineto events name no activity
    type: only a device and an annotation flag."""

    activity_type = None

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self.kind.startswith(("gpu", "kernel")) \
            else DeviceType.CPU

    def is_user_annotation(self):
        return "annotation" in self.kind


def test_events_without_an_activity_type():
    untyped = [UntypedEvent(e.kind, e.name(), e.start_ns(), e.duration_ns())
               for e in EVENTS]
    t, want = trace.reduce(untyped, 0.1), trace.reduce(EVENTS, 0.1)
    assert t["busy_s"] == pytest.approx(want["busy_s"])
    assert t["device_work"] == want["device_work"]
    assert t["idle_gaps"] == want["idle_gaps"]
    assert "bench.step" not in t["by_name"]


def test_idle_gaps_name_what_the_host_did():
    t = trace.reduce(EVENTS, window_s=0.1)
    labels = dict(t["idle_gaps"])
    # the gap [25, 50] has its midpoint in aten::item under bench.step
    assert labels["bench.step > aten::item"] == pytest.approx(25e-3)
    assert max(labels.values()) == pytest.approx(25e-3)


def test_followers_count_after_their_kernel():
    t = trace.reduce(EVENTS, window_s=0.1)
    own = trace.kernel_seconds(t, [r"mma_fwd_kernel"])
    both = trace.kernel_seconds(t, [r"mma_fwd_kernel"], [r"channel_sums::"])
    assert own == pytest.approx(10e-3)
    assert both == pytest.approx(12e-3)  # the sums after the fill: not its
    assert trace.kernel_seconds(t, [r"no_such_kernel"]) == 0.0


def fake_run(unit="step", traced=True, **cell):
    t = trace.reduce(EVENTS, window_s=0.1) if traced else None
    record = {"count": 4, "clips": 4 * 128, "window_s": 0.1,
              "latencies_s": [0.01 * (i + 1) for i in range(20)]}
    session = types.SimpleNamespace(unit=unit,
                                    flops_per_unit=lambda: 1e12)
    c = types.SimpleNamespace(
        config={"name": "stgcn_ntu60", **manifest.config("stgcn_ntu60")},
        params={"batch": 128, "dtype": "bfloat16", "fused_sgcn": True,
                "fused_sgcn_min_channels": 0, "fused_tconv": True,
                "peak": "bfloat16", **cell})
    return runner.Run(c, session, record, t, 12.5, 3 * 2**30)


def read(name, run):
    return manifest.module("metrics", name).read(run)


def test_end_to_end_readers():
    run = fake_run()
    assert read("setup_s", run) == 12.5
    assert read("peak_mem_gib", run) == 3.0
    assert read("train_clips_per_s", run) == pytest.approx(5120.0)
    assert read("serve_clips_per_s", run) is None
    serve = fake_run(unit="request")
    assert read("serve_p95_ms", serve) == pytest.approx(190.5)
    assert read("train_clips_per_s", serve) is None


def test_per_layer_readers():
    run = fake_run()
    assert read("idle_pct.train", run) == pytest.approx(68.0)
    assert read("idle_pct.serve", run) is None
    assert read("launches_per_step.train", run) == pytest.approx(1.5)
    # over the busy 32 ms, not the 100 ms window
    assert read("train_mfu", run) == pytest.approx(
        100 * 4e12 / 32e-3 / 989.4e12)
    # the ten blocks' least time for 4 steps over 12 ms: the forward
    # kernel's 10 and the channel sums that follow it, 2
    builder = manifest.module("models", "stgcn_ntu60")
    sgcn = manifest.module("counts", "sgcn")
    least = sum(peaks.least_seconds(*sgcn.fwd(**shape), "bfloat16")
                for shape in builder.op_shapes(run.cell.config,
                                               run.cell.params)["sgcn"])
    assert read("sgcn_fwd_roofline", run) == pytest.approx(
        100 * least * 4 / 12e-3)
    # no kernel of the op in the trace: nothing to read, never 0
    assert read("tconv_bwd_roofline", run) is None
    assert read("radar_fwd_roofline", run) is None
    serve = fake_run(unit="request")
    assert read("serve_mfu", serve) == pytest.approx(
        100 * 4e12 / 32e-3 / 989.4e12)
    assert read("train_mfu", serve) is None
    untraced = fake_run(traced=False)
    for name in ("idle_pct.train", "train_mfu", "sgcn_fwd_roofline"):
        assert read(name, untraced) is None
    assert read("serve_mfu", fake_run(unit="request", traced=False)) is None
