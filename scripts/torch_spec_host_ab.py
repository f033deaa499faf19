#!/usr/bin/env python3
"""Time the host-bound spectrogram paths of ``chip_smoke.py`` on a CUDA
card, for comparing two checkouts of the port on one card.

Run from the root of the checkout to time (its ``chip_smoke.py`` and
package are the ones imported):

    PYTHONPATH=. python path/to/torch_spec_host_ab.py

It builds the radar and STFT kernels, then runs ``chip_smoke.py``'s
``spec_train`` phase (full-width VirtualRadar + ResNet-18 steps at B=16,
radar frozen and unfrozen, kernels and plain routes, and a profile of the
unfrozen kernel steps) and its ``radar_dense_path`` (the dense and spline
radar routes, forward and forward + backward). These steps are bound by
the host's launches, so their times move with the host from call to call:
compare two checkouts only inside one call, in turns (parent, change,
change, parent), each in a process of its own. Prints ``chip_smoke.py``'s
JSON lines.

Each profile's device-busy time is read two ways from the same trace:
``chip_smoke.trace``'s (every device event, a ``record_function`` range
such as an optimizer's step included: it shows on the device as one span
from its first kernel to its last, gaps and all) as ``busy_ms_per_step``
and ``idle_share``, and the kernels, copies and fills alone as
``kernel_busy_ms_per_step`` and ``kernel_idle_share``.
"""

from __future__ import annotations

import os
from concurrent import futures

import torch

import chip_smoke
from skeleton_action_recognition_tpu_torch.ops import build, resample

SOURCES = ("radar_fwd.cu", "radar_bwd.cu", "stft_fwd.cu", "stft_bwd.cu",
           "radar_dense_fwd.cu", "radar_dense_bwd.cu")


def kernels_only(trace):
    """``chip_smoke.trace`` with the same trace's device-busy time and idle
    share over its kernels, copies and fills alone beside."""
    from torch.autograd import DeviceType

    def traced(run, steps):
        prof, summary, by_name = trace(run, steps)
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation)
        if spans:
            busy, end = 0.0, spans[0][0]
            for start, stop in spans:
                busy += max(0.0, stop - max(start, end))
                end = max(end, stop)
            summary.update(
                kernel_events=len(spans),
                kernel_busy_ms_per_step=busy / 1e3 / steps,
                kernel_idle_share=1.0 - busy / (end - spans[0][0]))
        return prof, summary, by_name

    return traced


def main():
    print(f"checkout {os.getcwd()}", flush=True)
    chip_smoke.phase_env()
    with futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.load_library, SOURCES))
    device = torch.device("cuda", 0)
    chip_smoke.trace = kernels_only(chip_smoke.trace)
    chip_smoke.phase_spec_train(device)
    x = chip_smoke.spec_clips(chip_smoke.SPEC_BATCH, chip_smoke.SEED)[0]
    op = resample.pad_frames_operator(chip_smoke.SPEC_T, chip_smoke.SPEC_UP)
    chip_smoke.dense_path(device, torch.from_numpy(x).to(device),
                          torch.from_numpy(op).to(device),
                          torch.tensor([0.1, -0.2, 0.3], device=device))
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
