"""Loaders of the VirtualRadar demo's inputs, on the host in numpy.

Counterpart of ``skeleton_action_recognition_tpu/data/demo.py``, the
loaders of the reference's ``utils.py``:

* :func:`load_azure_kinect`: an Azure Kinect body-tracking JSON -> joints
  in metres and the 26-edge skeleton (``utils.py:29-50``);
* :func:`load_ntu_file`: one raw NTU ``.skeleton`` file -> ``(M, T, V,
  3)`` joints and the radar's edge list (``utils.py:61-69``).
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

from skeleton_action_recognition_tpu_torch.data.skeleton import read_xyz
from skeleton_action_recognition_tpu_torch.graphs.azure_kinect import (
    AZURE_KINECT_EDGES,
)
from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    RADAR_EDGES,
)


def load_azure_kinect(filename: str) -> Tuple[np.ndarray, List]:
    """``((T, 32, 3) metres, edges)``: the first body of every frame that
    tracked one (frames without a body are dropped), millimetres turned
    into metres."""
    with open(filename) as f:
        doc = json.load(f)
    frames = [
        frame["bodies"][0]["joint_positions"]
        for frame in doc["frames"]
        if frame["num_bodies"] > 0
    ]
    return np.asarray(frames, np.float64) * 0.001, list(AZURE_KINECT_EDGES)


def load_ntu_file(filename: str) -> Tuple[np.ndarray, List]:
    """``((M, T, V, 3), edges)`` of one raw NTU clip, through
    :func:`..skeleton.read_xyz`."""
    data = read_xyz(filename)  # (3, T, V, M)
    return np.transpose(data, (3, 1, 2, 0)), list(RADAR_EDGES)
