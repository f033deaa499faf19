#!/usr/bin/env python3
"""Time the fused ST-GCN block's tail kernels (``csrc/block_tail.cu``) on
the card, beside their bounds and their plain versions.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=. python scripts/torch_block_tail_bench.py

It runs ``chip_smoke.py``'s ``block_tail_kernel`` phase alone: for each
stride-1 block shape (T, C) at NM=256, ``u`` in f32 and bf16 and each
residual (none, f32, bf16), one JSON line with the checks against the
plain versions and the CUDA-event times (mean of 20 calls after 3) of
``block_tail_fwd``, ``block_tail_bwd`` (with its channel sums) and
``tconv_gue``, each alone through its wrapper, beside its bound (its
tensors' bytes over 3.35 TB/s: with a bf16 ``u`` and an f32 residual 10,
16 and 6 bytes an element) and the plain versions' times, which run the
eager passes the kernels replace. ``blocks`` says how many of a step's
eight fused blocks take that combination. Then the times summed over the
eight blocks of a step, by ``u``'s dtype, and the card's name and power
limit.
"""

from __future__ import annotations

import json

import torch

import chip_smoke


def main():
    chip_smoke.phase_env()  # raises without a card
    totals = chip_smoke.phase_block_tail_kernel(torch.device("cuda", 0))
    print(json.dumps({"eight_blocks": totals}), flush=True)
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
