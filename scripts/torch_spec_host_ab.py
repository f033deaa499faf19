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
JSON lines. Each profile's ``busy_ms_per_step`` and ``idle_share`` are the
benchmark's (``chip_smoke.trace``): the kernels, copies and fills alone,
over the profiled window.
"""

from __future__ import annotations

import os
from concurrent import futures

import torch

import chip_smoke
from skeleton_action_recognition_tpu_torch.ops import build, resample

SOURCES = ("radar_fwd.cu", "radar_bwd.cu", "stft_fwd.cu", "stft_bwd.cu",
           "radar_dense_fwd.cu", "radar_dense_bwd.cu")


def main():
    print(f"checkout {os.getcwd()}", flush=True)
    chip_smoke.phase_env()
    with futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.load_library, SOURCES))
    device = torch.device("cuda", 0)
    chip_smoke.phase_spec_train(device)
    x = chip_smoke.spec_clips(chip_smoke.SPEC_BATCH, chip_smoke.SEED)[0]
    op = resample.pad_frames_operator(chip_smoke.SPEC_T, chip_smoke.SPEC_UP)
    chip_smoke.dense_path(device, torch.from_numpy(x).to(device),
                          torch.from_numpy(op).to(device),
                          torch.tensor([0.1, -0.2, 0.3], device=device))
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
