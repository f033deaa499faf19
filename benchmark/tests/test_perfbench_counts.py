"""The work counts under ``counts/`` against ``chip_smoke.py``'s bounds at
the shapes kernels #1-#11 run at on the main paths, and the roofline's
shapes against the model builders."""

import numpy as np
import pytest
import torch

import chip_smoke
from harness import manifest, peaks

SGCN = manifest.module("counts", "sgcn")
TCONV = manifest.module("counts", "tconv")
RADAR = manifest.module("counts", "radar")
STFT = manifest.module("counts", "stft")
REFERENCE = manifest.module("reference", "stgcn_ntu60")


def test_adjacency_nonzeros():
    assert np.count_nonzero(REFERENCE.spatial_adjacency()) == (
        SGCN.ADJACENCY_NONZEROS)


@pytest.mark.parametrize("shape", [s for s, _ in chip_smoke.BLOCK_SHAPES])
@pytest.mark.parametrize("backward", [False, True])
def test_sgcn_operations(shape, backward):
    t, c_in, c_out = shape
    a = torch.from_numpy(REFERENCE.spatial_adjacency())
    frames = chip_smoke.TRAIN_NM * t
    assert SGCN.operations(frames * 25, c_in, c_out, backward) == (
        chip_smoke.sgcn_flops(frames, c_in, c_out, a, backward))


@pytest.mark.parametrize("shape", chip_smoke.TCONV_SHAPES)
@pytest.mark.parametrize("backward", [False, True])
def test_tconv_operations(shape, backward):
    (t, c), _ = shape
    rows = chip_smoke.TRAIN_NM * t * 25
    assert TCONV.operations(rows, c, backward) == chip_smoke.tconv_flops(
        rows, c, backward)


def test_radar_operations():
    assert (RADAR.FWD_OPS, RADAR.BWD_OPS, RADAR.BWD_LOC_LAM_OPS) == (
        chip_smoke.RADAR_FWD_OPS, chip_smoke.RADAR_BWD_OPS,
        chip_smoke.RADAR_BWD_LOC_LAM_OPS)
    pairs = 48
    t_out = chip_smoke.SPEC_T * chip_smoke.SPEC_UP
    ops, _ = RADAR.fwd(chip_smoke.SPEC_BATCH, chip_smoke.SPEC_T, t_out, pairs)
    assert ops == chip_smoke.RADAR_FWD_OPS * chip_smoke.SPEC_BATCH * t_out * (
        pairs)


@pytest.mark.parametrize("backward", [False, True])
def test_stft_operations(backward):
    n, t = chip_smoke.SPEC_BATCH, chip_smoke.SPEC_T * chip_smoke.SPEC_UP
    frames = t // 16 + 1
    count = (STFT.bwd if backward else STFT.fwd)(n, t, 16, 256)[0]
    assert count == chip_smoke.stft_ops(n, frames, 256, backward)


def test_least_time_is_the_larger_bound():
    assert peaks.least_seconds(989.4e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert peaks.FLOPS["float32"] == chip_smoke.PEAK_FLOPS["f32"]
    assert peaks.FLOPS["bfloat16"] == pytest.approx(
        chip_smoke.PEAK_FLOPS["bf16"], rel=1e-3)
    assert peaks.HBM_BYTES == chip_smoke.PEAK_BYTES


def test_train_cell_shapes_cover_the_fused_blocks():
    config = {"name": "stgcn_ntu60", **manifest.config("stgcn_ntu60")}
    params = manifest.workload("stgcn_train_b128_bf16")["params"]
    shapes = manifest.module("models", "stgcn_ntu60").op_shapes(config,
                                                                params)
    got = [(s["rows"] // (256 * 25), s["c_in"], s["c_out"])
           for s in shapes["sgcn"]]
    want = [s for s, n in chip_smoke.BLOCK_SHAPES for _ in range(n)]
    assert got == want
    assert [(s["rows"] // (256 * 25), s["c"]) for s in shapes["tconv"]] == [
        s for s, n in chip_smoke.TCONV_SHAPES for _ in range(n)]
