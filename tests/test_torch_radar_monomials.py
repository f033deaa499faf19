"""The spline radar kernels' contract on their monomials ``e (num_tiles,
4 NS, tile)``: those of ``spline_tile_plan``, one slot a row with its
constant term, the slots of a tile nondecreasing. ``check_monomials``
accepts the plan's at the shapes the port uses and refuses every other
kind, so that no kernel is handed monomials it would sum wrongly or turn
into NaN. It runs on any device, and here on the CPU."""

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu_torch.ops import radar
from skeleton_action_recognition_tpu_torch.ops.resample import (
    spline_tile_plan,
)


def _monomials(t_in, up, tile):
    return torch.from_numpy(np.ascontiguousarray(
        spline_tile_plan(t_in, up, tile)[2].swapaxes(1, 2)))


def _slot_of_row(e, j, r):
    return int((e[j].unflatten(0, (-1, 4))[:, 3, r] != 0).int().argmax())


@pytest.mark.parametrize("t_in,up,tile", [(300, 250, 512), (30, 50, 128),
                                          (30, 50, 256), (20, 10, 64)])
def test_the_plans_monomials_pass(t_in, up, tile):
    e = _monomials(t_in, up, tile)
    radar.check_monomials(e)
    radar.check_monomials(e)  # kept: the second call checks nothing


def _flipped(e):
    return e.flip(2).contiguous()


def _second_slot(e):
    out = e.clone()
    s = _slot_of_row(e, 0, 3)
    other = 4 * ((s + 1) % (e.shape[1] // 4))
    out[0, other:other + 4, 3] = 0.5
    return out


def _no_constant(e):
    out = e.clone()
    out[0, 4 * _slot_of_row(e, 0, 5) + 3, 5] = 0.0
    return out


def _stray_term(e):
    out = e.clone()
    s = _slot_of_row(e, 0, 7)
    out[0, 4 * ((s + 1) % (e.shape[1] // 4)) + 1, 7] = 0.25
    return out


@pytest.mark.parametrize("spoil", [_flipped, _second_slot, _no_constant,
                                   _stray_term])
def test_other_monomials_raise(spoil):
    """Slots that decrease, a row in two slots, a row without its
    constant term, a term outside the row's slot."""
    with pytest.raises(ValueError, match="monomials of spline_tile_plan"):
        radar.check_monomials(spoil(_monomials(20, 10, 64)))


def test_a_monomials_tensor_written_to_is_checked_again():
    e = _monomials(20, 10, 64)
    radar.check_monomials(e)
    e.copy_(_flipped(e))  # a new version of the same memory
    with pytest.raises(ValueError):
        radar.check_monomials(e)
