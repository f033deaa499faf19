"""Spectrogram classifier: the VirtualRadar layer and ResNet-18.

Counterpart of ``skeleton_action_recognition_tpu/models/spectrogram.py``:
skeleton joints ``(N, 3, T, V, M)`` -> the radar return of their bones ->
the centered log-magnitude STFT ``(N, n_fft, frames)`` -> a nearest resize
to ``image_size x image_size`` -> ResNet-18. The radar's wavelength and
location are the parameters ``virtual_radar.radar_lambda`` and
``virtual_radar.radar_loc``, which the spectrogram trainer freezes and
unfreezes by name.

Routing (as the JAX module's): with ``num_pad_frames > 1`` the clip is
smoothed and upsampled on the device, through the spline radar kernels
(:func:`..ops.radar.radar_return_spline`) when ``use_pallas`` and through
the dense operator in plain torch otherwise; with ``num_pad_frames <= 1``
the raw frames go through :func:`..ops.virtual_radar.radar_return`. The
STFT runs through the fused log-magnitude kernels
(:func:`..ops.stft_logmag.stft_logmag`) when ``use_pallas_stft`` and the
bases are frozen, and through :mod:`..ops.stft` otherwise. The flags keep
the JAX names; here they select the CUDA kernels, which the wrappers
replace by their plain versions on CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import (
    RADAR_EDGES,
)
from skeleton_action_recognition_tpu_torch.models.resnet18 import ResNet
from skeleton_action_recognition_tpu_torch.ops import stft as stft_ops
from skeleton_action_recognition_tpu_torch.ops.radar import (
    radar_return_spline,
)
from skeleton_action_recognition_tpu_torch.ops.resample import (
    pad_frames_operator,
)
from skeleton_action_recognition_tpu_torch.ops.stft_logmag import (
    stft_logmag,
)
from skeleton_action_recognition_tpu_torch.ops.virtual_radar import (
    radar_return,
    radar_return_upsampled,
)


@functools.lru_cache(maxsize=8)
def _nearest_index(size: int, out: int, device) -> torch.Tensor:
    """``floor(arange(out) * size / out)`` on ``device``, kept per shape (a
    copy from the host on every call would wait for the device; a normal
    tensor even under ``torch.inference_mode``, so that a training step
    can save it)."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            np.floor(np.arange(out) * size / out).astype(np.int64)).to(device)


def nearest_resize_torch(x, out_h: int, out_w: int):
    """Nearest-neighbour resize of the last two axes with
    ``torch.nn.functional.interpolate``'s default index rule: ``src =
    floor(dst * in / out)`` (not half-pixel centered)."""
    rows = _nearest_index(x.shape[-2], out_h, x.device)
    cols = _nearest_index(x.shape[-1], out_w, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


@functools.lru_cache(maxsize=4)
def _pad_operator(t_in: int, num_pad_frames: int, sigma: float, device):
    """The dense ``(t_in * num_pad_frames, t_in)`` smoothing-and-upsampling
    operator on ``device``, kept per shape (a constant, a normal tensor
    even under ``torch.inference_mode``)."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            pad_frames_operator(t_in, num_pad_frames, sigma)
        ).to(device)


class VirtualRadar(nn.Module):
    """Joints ``(N, 3, T, V, M)`` -> log-magnitude spectrogram ``(N,
    n_fft, T_out // hop + 1)`` with zero Doppler centered, ``T_out = T *
    num_pad_frames`` when ``num_pad_frames > 1``. The radar return and the
    STFT compute in float32; on CUDA the layer raises while
    ``torch.backends.cuda.matmul.allow_tf32`` is on."""

    def __init__(
        self,
        edges: Tuple[Tuple[int, int], ...] = tuple(RADAR_EDGES),
        wavelength: float = 1e-3,
        radar_location: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        n_fft: int = 256,
        hop_length: int = 16,
        train_stft_kernel: bool = False,
        num_pad_frames: int = 0,
        pad_sigma: float = 3.0,
        use_pallas: bool = False,
        use_pallas_stft: bool = False,
    ):
        super().__init__()
        self.edges = tuple(edges)
        self.hop_length = hop_length
        self.train_stft_kernel = train_stft_kernel
        self.num_pad_frames = num_pad_frames
        self.pad_sigma = pad_sigma
        self.use_pallas = use_pallas
        self.use_pallas_stft = use_pallas_stft
        self.radar_lambda = nn.Parameter(
            torch.tensor(wavelength, dtype=torch.float32)
        )
        self.radar_loc = nn.Parameter(
            torch.tensor(radar_location, dtype=torch.float32)
        )
        cos, sin = (torch.from_numpy(b) for b in stft_ops.stft_basis(n_fft))
        if train_stft_kernel:
            self.stft_cos = nn.Parameter(cos.clone())
            self.stft_sin = nn.Parameter(sin.clone())
        else:  # constants: no part of the state_dict
            self.register_buffer("stft_cos", cos.clone(), persistent=False)
            self.register_buffer("stft_sin", sin.clone(), persistent=False)

    def forward(self, x):
        if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            # JAX pins these contractions at HIGHEST precision; torch's
            # switch is global, so the layer refuses to run without it
            raise ValueError(
                "VirtualRadar needs float32 matrix products in full float32: "
                "TF32 rounds the upsampled joint positions to ~1e-3, which "
                "the 4 pi d / lambda phase turns into noise. Set "
                "torch.backends.cuda.matmul.allow_tf32 = False"
            )
        x = x.float()
        lam, loc = self.radar_lambda, self.radar_loc
        if self.num_pad_frames > 1:
            if self.use_pallas:
                re, im = radar_return_spline(
                    x, self.num_pad_frames, loc, lam, self.edges,
                    sigma=self.pad_sigma,
                )
            else:
                w = _pad_operator(x.shape[2], self.num_pad_frames,
                                  self.pad_sigma, x.device)
                re, im = radar_return_upsampled(x, w, loc, lam, self.edges)
        else:
            re, im = radar_return(x, loc, lam, self.edges)
        if self.use_pallas_stft and not self.train_stft_kernel:
            return stft_logmag(re.contiguous(), im.contiguous(),
                               self.hop_length, self.stft_cos, self.stft_sin)
        s_re, s_im = stft_ops.stft_complex(
            re, im, self.hop_length, self.stft_cos, self.stft_sin
        )
        return stft_ops.log_magnitude(s_re, s_im)


class Model(nn.Module):
    """VirtualRadar spectrogram -> ResNet-18 logits ``(N, num_classes)``.
    ``dtype`` is the ResNet's compute type; the radar and the STFT stay
    float32 under any ``dtype`` (the phase ``4 pi d / lambda`` is ~1e4 rad
    at real wavelengths, beyond a bfloat16's three digits)."""

    def __init__(
        self,
        num_classes: int = 60,
        num_filters: int = 64,
        image_size: int = 256,
        wavelength: float = 5e-4,
        train_stft_kernel: bool = False,
        num_pad_frames: int = 0,
        use_pallas: bool = False,
        use_pallas_stft: bool = False,
        dtype=None,
        device=None,
        generator=None,
    ):
        super().__init__()
        self.image_size = image_size
        self.virtual_radar = VirtualRadar(
            wavelength=wavelength, train_stft_kernel=train_stft_kernel,
            num_pad_frames=num_pad_frames, use_pallas=use_pallas,
            use_pallas_stft=use_pallas_stft,
        )
        self.base_model = ResNet(num_classes=num_classes,
                                 num_filters=num_filters, dtype=dtype,
                                 generator=generator)
        self.to(device)

    def forward(self, x):
        spec = self.virtual_radar(x)
        spec = nearest_resize_torch(spec, self.image_size, self.image_size)
        return self.base_model(spec[..., None])  # NHWC, one channel
