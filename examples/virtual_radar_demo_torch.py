"""VirtualRadar demo on the PyTorch port: micro-Doppler spectrograms of the
reference's three demo inputs, through the dense radar kernel (#8) and the
STFT log-magnitude kernel (#10).

The counterpart of ``examples/virtual_radar_demo.py`` (the reference's
``virtual_radar_example.ipynb``). Each input's frames are smoothed over the
joints (``ops/resample.py::pad_frames``'s ``smooth_axis="joints"``), then
upsampled ``pad`` times by the not-a-knot cubic operator inside the radar
return (``ops/radar.py::radar_return_fused``, kernel #8), and the return's
STFT log-magnitude is kernel #10's (``ops/stft_logmag.py``). It prints the
notebook's anchors (name, shape, min, max) and the cross-check of its cell
8 against ``scipy.signal.stft``, and saves each spectrogram as ``.npy``
(and as a PNG where matplotlib imports).

Usage (from the repository root; on the card unless ``--cpu``, where each
stage takes its plain PyTorch version):

    python examples/virtual_radar_demo_torch.py --data-root DATA \
        [--out-dir radar_demo] [--cpu]

``DATA`` holds the reference's ``cmu_mocap.npy`` (``(T, 42, 3)``, mm),
``simulated_gait.npy`` (``(T, 17, 3)``, m) and
``NTU_preprocessed_skeleton_examples.npy`` (``(N, 3, T, 25, 2)``, m).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from skeleton_action_recognition_tpu_torch import ops  # noqa: E402
from skeleton_action_recognition_tpu_torch.graphs import (  # noqa: E402
    RADAR_EDGES,
)
from skeleton_action_recognition_tpu_torch.ops import (  # noqa: E402
    radar,
    stft_logmag,
)
from skeleton_action_recognition_tpu_torch.ops.precision import (  # noqa
    einsum_f32,
)
from skeleton_action_recognition_tpu_torch.parallel.sharding import (  # noqa
    resolve_device,
)

SIGMA = 3.0  # pad_frames' Gaussian over the joints
N_FFT, HOP = 256, 16
GAIT_EDGES = [
    (0, 1), (1, 2), (1, 3), (3, 5), (5, 7), (1, 4), (4, 6), (6, 8),
    (0, 9), (9, 11), (11, 13), (13, 15), (0, 10), (10, 12),
    (12, 14), (14, 16),
]
# name -> (file under --data-root, edges, wavelength, upsampling): the
# notebook's cells 2-4
DEMOS = {
    "cmu_mocap": ("cmu_mocap.npy", [(i, i + 1) for i in range(41)], 5e-3, 20),
    "simulated_gait": ("simulated_gait.npy", GAIT_EDGES, 5e-4, 10),
    "ntu_example": ("NTU_preprocessed_skeleton_examples.npy",
                    list(RADAR_EDGES), 9e-4, 550),
}


def load_inputs(data_root: str) -> dict:
    """``{name: (T, V, 3) metres}`` of the three inputs: CMU converted from
    mm, the NTU example's first clip and body. Raises
    ``FileNotFoundError`` naming every file that is missing."""
    missing = [os.path.join(data_root, f) for f, *_ in DEMOS.values()
               if not os.path.exists(os.path.join(data_root, f))]
    if missing:
        raise FileNotFoundError(
            "the VirtualRadar demo needs the reference's data files: "
            + ", ".join(missing))

    def load(name):
        return np.load(os.path.join(data_root, DEMOS[name][0]))

    return {
        "cmu_mocap": load("cmu_mocap") * 0.001,
        "simulated_gait": load("simulated_gait"),
        "ntu_example": load("ntu_example")[0, :, :, :, 0].transpose(1, 2, 0),
    }


def spectrogram(data, edges, wavelength, pad, device):
    """``(spectrogram (256, T * pad // 16 + 1), (re, im))`` of ``data (T,
    V, 3)`` seen from the origin: the frames smoothed over the joints, the
    radar return through kernel #8 against ``cubic_interp_matrix(T, T *
    pad)``, each ``(1, T * pad)``, then kernel #10's centered STFT
    log-magnitude, zero Doppler centered (the plain versions on the
    CPU)."""
    x = torch.as_tensor(data, dtype=torch.float32, device=device)
    t, v, _ = x.shape
    g = torch.from_numpy(
        ops.gaussian_smooth_matrix(v, SIGMA).astype(np.float32)).to(device)
    smoothed = einsum_f32("vu,tuc->tvc", g, x)
    operator = torch.from_numpy(
        ops.cubic_interp_matrix(t, t * pad).astype(np.float32)).to(device)
    re, im = radar.radar_return_fused(
        smoothed.permute(2, 0, 1)[None, ..., None].contiguous(), operator,
        torch.zeros(3, device=device),
        torch.tensor(wavelength, device=device), edges)
    cos, sin = (torch.from_numpy(b).to(device)
                for b in ops.stft_basis(N_FFT))
    return stft_logmag.stft_logmag(re, im, HOP, cos, sin)[0], (re, im)


def scipy_cross_check(re, im, ours):
    """The notebook's cell 8: ``scipy.signal.stft`` of the same return
    (Hann, 256 samples, hop 16, even boundary), scaled by the window's sum
    and fftshifted, against ``ours``; ``(mean, 99th percentile)`` of
    ``|dlog|`` over scipy's above-median bins."""
    from scipy import signal as ssig

    sig = re[0].double().cpu().numpy() + 1j * im[0].double().cpu().numpy()
    _, _, spec = ssig.stft(
        sig, nperseg=N_FFT, noverlap=N_FFT - HOP, window="hann",
        return_onesided=False, boundary="even", padded=False,
    )
    win_sum = ssig.get_window("hann", N_FFT, fftbins=True).sum()
    want = np.log(np.abs(np.fft.fftshift(spec * win_sum, axes=0)) + 1e-6)
    n = min(ours.shape[1], want.shape[1])
    mask = want[:, :n] > np.median(want)
    diff = np.abs(ours[:, :n] - want[:, :n])[mask]
    return float(diff.mean()), float(np.quantile(diff, 0.99))


def save(out_dir, name, spec):
    """``<name>.npy``, and ``<name>.png`` where matplotlib imports; returns
    the paths written."""
    paths = [os.path.join(out_dir, f"{name}.npy")]
    np.save(paths[0], spec)
    try:
        import matplotlib
    except ImportError:
        return paths
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(20, 10))
    plt.imshow(spec, aspect="auto", cmap="jet")
    plt.colorbar()
    paths.append(os.path.join(out_dir, f"{name}.png"))
    plt.savefig(paths[1], dpi=60)
    plt.close()
    return paths


def main(argv=None):
    """Run the demo; returns ``{name: spectrogram}`` (numpy) and the
    cross-check's ``(mean, p99)`` under ``"scipy_cross_check"``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out-dir", default="radar_demo")
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (plain versions of the kernels)")
    arg = parser.parse_args(argv)
    device = resolve_device("cpu" if arg.cpu else "cuda")
    inputs = load_inputs(arg.data_root)
    os.makedirs(arg.out_dir, exist_ok=True)

    results, signals = {}, {}
    for name, (_, edges, wavelength, pad) in DEMOS.items():
        spec, signals[name] = spectrogram(inputs[name], edges, wavelength,
                                          pad, device)
        spec = spec.cpu().numpy()
        paths = save(arg.out_dir, name, spec)
        print(f"{name}: shape {spec.shape} min {spec.min():.3f} "
              f"max {spec.max():.3f} -> {', '.join(paths)}")
        results[name] = spec

    mean, p99 = scipy_cross_check(*signals["simulated_gait"],
                                  results["simulated_gait"])
    print(f"scipy cross-check: mean |dlog| {mean:.4f} (99p {p99:.4f})")
    results["scipy_cross_check"] = (mean, p99)
    return results


if __name__ == "__main__":
    main()
