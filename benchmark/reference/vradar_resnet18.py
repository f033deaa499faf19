"""Plain reference of the VirtualRadar spectrogram classifier
(``vradar_resnet18``: the skeleton's bones as radar scatterers, their
micro-Doppler spectrogram classified by a ResNet-18), as the configuration
states it.

Plain PyTorch and NumPy (SciPy builds the resampling operator), nothing of
the program:

* the joints are smoothed over time (a Gaussian of ``sigma`` frames,
  reflecting at the ends) and upsampled ``upsample`` times by the
  not-a-knot cubic spline through them: one dense ``(T_out, T)`` operator;
* each bone of ``edges`` in each body is an ellipsoid scatterer seen from
  ``radar_loc`` at wavelength ``radar_lambda``: amplitude
  ``sqrt(pi c) / |sin^2 t + c cos^2 t|`` (``c`` the squared mean bone
  length over the upsampled clip, ``t`` the angle between the bone and the
  line from its middle to the radar) and phase ``4 pi d / lambda`` (``d``
  the source joint's distance); the complex returns are summed;
* the centered STFT (reflect padding, periodic Hann window of ``n_fft``,
  hop ``hop``), ``log(|S| + 1e-6)`` with zero Doppler centered, and the
  nearest resize (``floor(i * size / out)``) to ``image`` x ``image``;
* ResNet-18 (a one-channel 7x7 stem, four stages of two BasicBlocks,
  ``filters`` wide at first) with BatchNorm (epsilon 1e-5) and a dense
  head of ``num_classes`` logits.

The radar and the STFT run in float64, as the configuration states,
``rows`` clips at a time (and the STFT at the frames the resize keeps
alone), and hand the ResNet a float32 image; the ResNet runs in float32
with TF32 off.
The trainer's optimizer is written here too: Adam on the ResNet at the
triangular cycle's rate, and the wavelength and location moved along their
gradient's unit direction by a step proportional to their own size.

``control`` names a lower precision (``compare.rounding``) that the
operands of the radar's one contraction (the resampling of the joints, in
float32 with TF32 off as configured) and of the ResNet's convolutions and
head then take: ``tf32`` runs the radar and the STFT in float32 and
rounds the radar's contraction, and leaves the ResNet's (TF32 already, as
configured); ``bfloat16`` rounds the ResNet's alone.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from harness.compare import full_f32, rounding

JOINTS = 25
BN_EPSILON = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@functools.lru_cache(maxsize=4)
def resample_operator(frames: int, upsample: int, sigma: float):
    """The ``(frames * upsample, frames)`` smoothing-and-upsampling
    operator in float64 (SciPy's ``gaussian_filter1d``, reflecting, then
    ``interp1d(..., 'cubic')`` from ``linspace(0, 1, frames)`` to
    ``linspace(0, 1, frames * upsample)``)."""
    from scipy.interpolate import interp1d
    from scipy.ndimage import gaussian_filter1d

    smooth = gaussian_filter1d(np.eye(frames), sigma, axis=0)
    cubic = interp1d(np.linspace(0.0, 1.0, frames), np.eye(frames), "cubic",
                     axis=0)(np.linspace(0.0, 1.0, frames * upsample))
    return cubic @ smooth


def parameter_spec(config) -> dict:
    """``{name: (shape, kind)}``: the radar's two parameters (kind
    ``const``: the configuration's wavelength and location) and the
    ResNet's."""
    spec = {"virtual_radar.radar_lambda": ((), "const_wavelength"),
            "virtual_radar.radar_loc": ((3,), "const_location")}
    p = "base_model"
    f = config["filters"]

    def bn(prefix, c):
        for leaf, kind in (("weight", "bn_scale"), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            spec[f"{prefix}.{leaf}"] = ((c,), kind)

    spec[f"{p}.conv1.weight"] = ((f, 1, 7, 7), "conv")
    bn(f"{p}.bn1", f)
    c_in = f
    for name, c, stride in stages(config):
        b = f"{p}.{name}"
        spec[f"{b}.conv1.weight"] = ((c, c_in, 3, 3), "conv")
        bn(f"{b}.bn1", c)
        spec[f"{b}.conv2.weight"] = ((c, c, 3, 3), "conv")
        bn(f"{b}.bn2", c)
        if stride != 1 or c_in != c:
            spec[f"{b}.downsample_conv.weight"] = ((c, c_in, 1, 1), "conv")
            bn(f"{b}.downsample_bn", c)
        c_in = c
    spec[f"{p}.fc.weight"] = ((config["num_classes"], c_in), "fan_in")
    spec[f"{p}.fc.bias"] = ((config["num_classes"],), "zero")
    return spec


def stages(config):
    """``(name, filters, stride)`` of each BasicBlock."""
    out = []
    for s, blocks in enumerate(config["stage_sizes"]):
        for b in range(blocks):
            out.append((f"layer{s + 1}_{b}", config["filters"] * 2**s,
                        2 if s > 0 and b == 0 else 1))
    return out


def trainable(spec) -> list:
    return [k for k, (_, kind) in spec.items()
            if kind not in ("bn_mean", "bn_var")]


def safe_norm(v, dim):
    s = (v * v).sum(dim)
    zero = s == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, s)))


def radar_return(config, x, loc, lam, control=None):
    """The complex return ``(re, im)``, each ``(n, T_out)``, of joints
    ``x (n, 3, T, V, M)``: in float64, or in float32 under the ``tf32``
    control."""
    rnd = rounding(control if control == "tf32" else None)
    x = x.to(torch.float32 if control == "tf32" else torch.float64)
    w = torch.as_tensor(resample_operator(
        config["frames"], config["upsample"], config["sigma"]),
        dtype=x.dtype, device=x.device)
    edges = config["edges"]
    src = x[:, :, :, [e[0] for e in edges]]
    dst = x[:, :, :, [e[1] for e in edges]]
    ps = torch.einsum("ot,nctem->ncoem", rnd(w), rnd(src))
    pd = torch.einsum("ot,nctem->ncoem", rnd(w), rnd(dst))
    bone = pd - ps
    c = safe_norm(bone, 1).mean(1, keepdim=True) ** 2  # (n, 1, E, M)
    loc_b = loc.to(x.dtype)[None, :, None, None, None]
    dist = safe_norm(ps - loc_b, 1)
    mid = loc_b - (ps + pd) / 2.0
    ct = (mid * bone).sum(1) / (safe_norm(mid, 1) * safe_norm(bone, 1)
                                + 1e-6)
    ct2 = ct * ct
    amp = torch.sqrt(math.pi * c) / torch.abs((1.0 - ct2) + c * ct2)
    phase = (4.0 * math.pi / lam.to(x.dtype)) * dist
    return (amp * torch.cos(phase)).sum((2, 3)), (
        amp * torch.sin(phase)).sum((2, 3))


def kept_frames(config):
    """The STFT frames the nearest resize keeps, and the rows (bins)."""
    t_out = config["frames"] * config["upsample"]
    frames = t_out // config["hop"] + 1
    image = config["image"]
    cols = np.floor(np.arange(image) * frames / image).astype(np.int64)
    rows = np.floor(np.arange(image) * config["n_fft"] / image).astype(
        np.int64)
    return cols, rows


def spectrogram(config, x, loc, lam, control=None):
    """``(n, image, image)`` float32: the log-magnitude spectrogram of the
    return, zero Doppler centered, at the frames and bins the resize
    keeps, computed in the return's type."""
    re, im = radar_return(config, x, loc, lam, control)
    n_fft, hop = config["n_fft"], config["hop"]
    pad = n_fft // 2
    re = F.pad(re[:, None], (pad, pad), mode="reflect")[:, 0]
    im = F.pad(im[:, None], (pad, pad), mode="reflect")[:, 0]
    cols, rows = kept_frames(config)
    idx = torch.as_tensor(cols[:, None] * hop + np.arange(n_fft)[None, :],
                          device=x.device)
    window = torch.as_tensor(
        0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft),
        dtype=re.dtype, device=x.device)
    frames = torch.complex(re[:, idx], im[:, idx]) * window
    mag = torch.fft.fft(frames, dim=-1).abs()  # (n, kept frames, bins)
    logmag = torch.log(mag + 1e-6).transpose(1, 2)
    logmag = torch.roll(logmag, n_fft // 2, dims=1)
    return logmag[:, torch.as_tensor(rows, device=x.device)].float()


def batch_norm(x, w, prefix, train):
    """BatchNorm over the channels of an NCHW ``x``."""
    if train:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    scale = torch.rsqrt(var + BN_EPSILON) * w[f"{prefix}.weight"]
    return ((x - mean[:, None, None]) * scale[:, None, None]
            + w[f"{prefix}.bias"][:, None, None])


def resnet(config, w, image, train, control=None):
    """Logits of ``image (n, H, W)`` float32."""
    rnd = rounding(control if control != "tf32" else None)
    p = "base_model"

    def conv(x, name, stride, padding):
        return F.conv2d(rnd(x), rnd(w[name]), None, stride, padding)

    x = image[:, None]
    x = torch.relu(batch_norm(conv(x, f"{p}.conv1.weight", 2, 3), w,
                              f"{p}.bn1", train))
    x = F.max_pool2d(x, 3, 2, 1)
    c_in = config["filters"]
    for name, c, stride in stages(config):
        b = f"{p}.{name}"
        out = torch.relu(batch_norm(conv(x, f"{b}.conv1.weight", stride, 1),
                                    w, f"{b}.bn1", train))
        out = batch_norm(conv(out, f"{b}.conv2.weight", 1, 1), w,
                         f"{b}.bn2", train)
        if stride != 1 or c_in != c:
            x = batch_norm(conv(x, f"{b}.downsample_conv.weight", stride, 0),
                           w, f"{b}.downsample_bn", train)
        x = torch.relu(out + x)
        c_in = c
    return F.linear(rnd(x.mean((2, 3))), rnd(w[f"{p}.fc.weight"]),
                    w[f"{p}.fc.bias"])


def lr_schedule(params, count):
    """The triangular cycle from ``lr_min`` to ``lr`` and back every
    ``2 lr_cycle`` steps, at step ``count``."""
    lo, hi, step = params["lr_min"], params["lr"], params["lr_cycle"]
    cycle = math.floor(1 + count / (2 * step))
    x = abs(count / step - 2 * cycle + 1)
    return lo + (hi - lo) * max(0.0, 1.0 - x)


def train_readings(config, params, weights, batches, control=None):
    """Follow the program's first steps from ``weights``: each step's loss,
    the first gradient per ResNet leaf (on the host) and its norm, and the
    norm of each leaf's change after the last step (the radar's two leaves among them while they train).
    The spectrograms are taken ``rows`` clips at a time without a graph;
    the ResNet's gradient with respect to them is then carried back
    through each block's radar again."""
    spec = parameter_spec(config)
    names = trainable(spec)
    radar = [k for k in names if k.startswith("virtual_radar.")]
    train_radar = params["train_radar"]
    learned = [k for k in names if k not in radar or train_radar]
    device = batches[0][0].device
    rows = params.get("reference_rows", 8)
    with full_f32():
        w = {k: v.to(device).clone() for k, v in weights.items()}
        start = {k: w[k].clone() for k in learned}
        mu = {k: torch.zeros_like(w[k]) for k in learned if k not in radar}
        nu = {k: torch.zeros_like(w[k]) for k in learned if k not in radar}
        losses, grads = [], None
        for count, (x, y) in enumerate(batches):
            loc = w["virtual_radar.radar_loc"]
            lam = w["virtual_radar.radar_lambda"]
            with torch.no_grad():
                image = torch.cat([spectrogram(config, x[i:i + rows], loc,
                                               lam, control)
                                   for i in range(0, len(x), rows)])
            image.requires_grad_(train_radar)
            back = [k for k in learned if k not in radar]
            for k in back:
                w[k].requires_grad_(True)
            logits = resnet(config, w, image, True, control)
            loss = -(torch.log_softmax(logits, -1) * y).sum() / len(x)
            wanted = [w[k] for k in back] + ([image] if train_radar else [])
            g = list(torch.autograd.grad(loss, wanted))
            grad = dict(zip(back, g[:len(back)]))
            if train_radar:
                g_image = g[-1]
                loc_r = loc.detach().clone().requires_grad_(True)
                lam_r = lam.detach().clone().requires_grad_(True)
                for i in range(0, len(x), rows):
                    part = spectrogram(config, x[i:i + rows], loc_r, lam_r,
                                       control)
                    part.backward(g_image[i:i + rows])
                grad["virtual_radar.radar_loc"] = loc_r.grad
                grad["virtual_radar.radar_lambda"] = lam_r.grad
            losses.append(loss.item())
            if grads is None:
                grads = {k: grad[k].detach().cpu() for k in back}
            lr = lr_schedule(params, count)
            t = count + 1
            with torch.no_grad():
                for k in learned:
                    w[k] = w[k].detach()
                    if k in radar:
                        w[k] = w[k] + physics_update(params, k, w[k],
                                                     grad[k])
                        continue
                    mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * grad[k]
                    nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * grad[k] ** 2
                    denom = torch.sqrt(nu[k] / (1 - ADAM_B2**t)) + ADAM_EPS
                    w[k] = w[k] - lr * (mu[k] / (1 - ADAM_B1**t)) / denom
            del g, grad, image, logits, loss
        deltas = {k: (w[k] - start[k]).norm().item() for k in learned}
    return {"losses": losses, "grad_tensors": grads,
            "grads": {k: v.norm().item() for k, v in grads.items()},
            "deltas": deltas, "apart": radar if train_radar else []}


def physics_update(params, name, p, g):
    """The wavelength's (``lambda_rel_step`` of its size) or the
    location's (``loc_step`` meters, or that share of its size past 1 m)
    step along ``-g``'s unit direction."""
    if "radar_lambda" in name:
        scale = params["lambda_rel_step"] * p.abs().max()
    else:
        scale = params["loc_step"] * torch.clamp(p.abs().max(), min=1.0)
    g = torch.nan_to_num(g, nan=0.0)
    norm = g.norm()
    direction = g / norm if norm > 0 else torch.zeros_like(g)
    return -scale * direction


def flops(config, batch, train):
    """Operations of one training step of the ResNet (forward and backward)
    or one forward on ``batch`` images, counted by ``FlopCounterMode`` on
    the meta device over this reference; the radar and the STFT are
    counted apart (``counts/radar.py``, ``counts/stft.py``)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    spec = parameter_spec(config)
    w = {k: torch.empty(shape, device=meta, requires_grad=kind in (
        "conv", "fan_in", "zero", "bn_scale", "bn_bias"))
        for k, (shape, kind) in spec.items()}
    image = torch.empty((batch, config["image"], config["image"]),
                        device=meta)
    with FlopCounterMode(display=False) as counter:
        logits = resnet(config, w, image, train)
        if train:
            logits.sum().backward()
    return counter.get_total_flops()
