"""The port's spans and counters (``tracing.py``): no ``record_function``
without a profiler; under a CPU profiler the train steps' and the
predictor's phases once each, in order; ``ops.build.launch`` counts each
call and, profiled, is the range ``op.<name>`` around it."""

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from skeleton_action_recognition_tpu_torch import serving, tracing
from skeleton_action_recognition_tpu_torch.models import spectrogram, stgcn
from skeleton_action_recognition_tpu_torch.ops import build
from skeleton_action_recognition_tpu_torch.train import optim, schedules
from skeleton_action_recognition_tpu_torch.train import steps as steps_lib

torch.set_num_threads(2)  # as tests/torch_parity_helpers.py, for -n workers

TRAIN_PHASES = ["train.forward", "train.backward", "train.optimizer",
                "train.metrics"]
SERVE_PHASES = ["serve.input", "serve.forward", "serve.output"]


def spans(prof, prefix):
    """The names of the profile's events that start with ``prefix``, in
    the order they started."""
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.name.startswith(prefix)]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class OneRank:
    """A data-parallel stand-in of one rank: the sums are the values."""

    world_size = 1

    def all_reduce_gradients(self, model):
        pass

    def sum_metrics(self, metrics):
        return metrics


@pytest.fixture
def stand_in_cuda(monkeypatch):
    """``launch`` on the CPU: card 0 current, no device switch, stream 0."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build, "raw_stream", lambda index: 0)


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(tracing._profiler, "record_function", refuse)
    with tracing.span("train.forward"), tracing.span("op.sgcn_fwd"):
        pass
    assert tracing.span("a") is tracing.span("b")
    with cpu_profile():
        with pytest.raises(AssertionError, match="serve.input"):
            tracing.span("serve.input")


def test_counters_are_a_copy_and_reset():
    tracing.reset_counters()
    tracing.count("launch.a")
    tracing.count("launch.a", 2)
    seen = tracing.counters()
    seen["launch.a"] = 100
    assert tracing.counters()["launch.a"] == 3
    assert tracing.counters()["launch.never"] == 0
    tracing.reset_counters()
    assert tracing.counters() == {}


def test_counts_from_many_threads_are_not_lost():
    """More threads than cores, switching as often as the interpreter
    allows: every count arrives."""
    threads, each = 16, 2000
    before = tracing.counters()["launch.stress"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            tracing.count("launch.stress") for _ in range(each)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert tracing.counters()["launch.stress"] == before + threads * each


@pytest.mark.parametrize("dp", [None, OneRank()], ids=["one", "dp"])
def test_stgcn_train_step_emits_its_phases_in_order(dp):
    model = stgcn.Model(num_classes=6, remat=False)
    opt = optim.TFSGD(model.parameters(), schedules.piecewise_constant(
        0.01, [10]))
    step = steps_lib.make_train_step(model, opt, 2, dp=dp)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16, 25, 2)).astype(
        np.float32))
    y = torch.eye(6)[[1, 4]]
    step(x, y, False)  # the phases are spans only under a profiler
    with cpu_profile() as prof:
        metrics = step(x, y, False)
    want = list(TRAIN_PHASES)
    if dp is not None:
        want.insert(2, "train.allreduce")
    assert spans(prof, "train.") == want
    assert metrics["count"].item() == 2
    assert torch.isfinite(metrics["loss"])


def test_radar_train_step_emits_its_phases_in_order():
    model = spectrogram.Model(num_classes=4, num_filters=8, image_size=64,
                              num_pad_frames=20, use_pallas=True,
                              use_pallas_stft=True)
    opt = optim.RadarOptimizer(model.named_parameters(),
                               schedules.cyclic_triangular(1e-4, 0.1, 10))
    step = steps_lib.make_radar_train_step(model, opt, 2, train_lambda=True)
    x = torch.from_numpy((np.random.default_rng(1).normal(
        size=(2, 3, 30, 25, 2)) * 0.3).astype(np.float32))
    y = torch.eye(4)[[1, 3]]
    with cpu_profile() as prof:
        metrics = step(x, y)
    assert spans(prof, "train.") == TRAIN_PHASES
    assert metrics["count"].item() == 2


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one", "replicas"])
def test_predictor_emits_its_phases_in_order(devices):
    model = stgcn.Model(num_classes=6, generator=torch.Generator()
                        .manual_seed(0))
    x = np.random.default_rng(2).normal(size=(3, 3, 16, 25, 2)).astype(
        np.float32)
    one = serving.Predictor(model, max_batch=4, device="cpu")
    pred = serving.Predictor(model, max_batch=4, device="cpu",
                             devices=devices)
    with cpu_profile() as prof:
        probs = pred(x)
    assert spans(prof, "serve.") == SERVE_PHASES
    assert probs.shape == (3, 6)
    np.testing.assert_allclose(probs, one(x), rtol=0, atol=1e-6)


def test_launch_counts_and_opens_its_op_span(stand_in_cuda):
    calls = []

    def entry_point(*args):
        calls.append(args)
        with record_function("inside"):
            pass
        return 0

    before = tracing.counters()["launch.sgcn_fwd"]
    build.launch(entry_point, "sgcn_fwd", "cuda", 7, 8)
    assert calls == [(7, 8, 0)]
    assert tracing.counters()["launch.sgcn_fwd"] == before + 1
    with cpu_profile() as prof:
        build.launch(entry_point, "sgcn_fwd", "cuda", 7, 8)
    assert tracing.counters()["launch.sgcn_fwd"] == before + 2
    assert spans(prof, "op.") == ["op.sgcn_fwd"]
    (inside,) = [e for e in prof.events() if e.name == "inside"]
    assert inside.cpu_parent.name == "op.sgcn_fwd"


def test_a_refused_launch_raises_and_is_counted(stand_in_cuda):
    before = tracing.counters()["launch.tconv_bwd"]
    with pytest.raises(RuntimeError, match="tconv_bwd launch failed"):
        build.launch(lambda *args: 2, "tconv_bwd", "cuda")
    assert tracing.counters()["launch.tconv_bwd"] == before + 1
