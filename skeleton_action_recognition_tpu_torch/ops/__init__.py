"""Kernels for Hopper with their plain PyTorch versions, and the functional
ops around them.

Exports what the JAX package's ``ops`` exports, and
``radar_spectrogram_sharded``. Importing the package builds nothing: each
CUDA source is compiled at its kernel's first launch (:mod:`.build`).
"""

from skeleton_action_recognition_tpu_torch.ops.graph import (
    gin_aggregate,
    spatial_graph_conv,
)
from skeleton_action_recognition_tpu_torch.ops.resample import (
    cubic_interp_matrix,
    gaussian_smooth_matrix,
    pad_frames,
    pad_frames_operator,
)
from skeleton_action_recognition_tpu_torch.ops.stft import (
    log_magnitude,
    stft_basis,
    stft_complex,
    stft_real,
)
from skeleton_action_recognition_tpu_torch.ops.virtual_radar import (
    radar_return,
    radar_return_sharded,
    radar_return_upsampled,
    radar_spectrogram_sharded,
    virtual_radar_spectrogram,
)

__all__ = [
    "cubic_interp_matrix",
    "gaussian_smooth_matrix",
    "gin_aggregate",
    "log_magnitude",
    "pad_frames",
    "pad_frames_operator",
    "radar_return",
    "radar_return_sharded",
    "radar_return_upsampled",
    "radar_spectrogram_sharded",
    "spatial_graph_conv",
    "stft_basis",
    "stft_complex",
    "stft_real",
    "virtual_radar_spectrogram",
]
