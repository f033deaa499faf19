"""Serving: a softmax predictor over a model in eval mode.

Counterpart of ``skeleton_action_recognition_tpu/serving.py``'s
``Predictor``, with its ``from_checkpoint``. For the stock ST-GCN,
:mod:`.models.export` also provides the folded predictors (BatchNorms and
the adjacency stack folded into the products, in bfloat16, W8 or W8A8):
pass ``fused=True`` and ``quantize``. Where the JAX predictor shards a
request over a mesh, this one takes ``devices``: a replica on each, a
request split across them in order (:class:`Replicas`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.models import export
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    resolve_device,
)
from skeleton_action_recognition_tpu_torch.tracing import span
from skeleton_action_recognition_tpu_torch.train import checkpoint as ckpt_lib


class Replicas:
    """One forward on each of several devices: a batch's rows are split in
    order into as many contiguous parts of ``ceil(n / len(forwards))``
    rows (the last ones shorter or absent), each part runs on its device,
    and the outputs come back concatenated on the CPU. Every part is
    launched before any is read back, so the devices run at once."""

    def __init__(self, forwards, devices):
        if len(forwards) != len(devices) or not forwards:
            raise ValueError("one forward per device, at least one")
        self.forwards = list(forwards)
        self.devices = [torch.device(d) for d in devices]

    def split(self, x) -> list:
        """The host array ``x``'s parts, each on its device."""
        x = torch.as_tensor(np.asarray(x, np.float32))
        size = -(-len(x) // len(self.forwards))
        return [part.to(device) for device, part in
                zip(self.devices, x.split(max(size, 1)))]

    def forward(self, parts) -> list:
        """Each part's output, on its device."""
        return [fwd(part) for fwd, part in zip(self.forwards, parts)]

    def __call__(self, x) -> torch.Tensor:
        outs = self.forward(self.split(x))
        return torch.cat([out.cpu() for out in outs])


def replicate(model, devices) -> list:
    """``model`` on ``devices[0]`` and a copy of it on each further device
    (a device named twice gets two copies)."""
    first = model.to(devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in devices[1:]]


class Predictor:
    """Class probabilities for batches of up to ``max_batch`` clips, on
    ``device`` (the CUDA card unless the caller asks for the CPU; without a
    card, ``"cuda"`` raises).

    ``fused=True`` serves the folded predictor of the stock ST-GCN
    (:mod:`.models.export`; any other model raises ``ValueError``) in
    bfloat16, or with ``quantize='w8'`` (int8 weights) or ``'w8a8'`` (int8
    weights and activations). It is not the model's ``fused_sgcn`` option,
    which runs the unfolded model's spatial conv through the CUDA kernel:
    the folded predictors run no kernel of the port.

    ``devices`` (a list; None: ``[device]``) serves a replica of the model
    (or of its folded predictor) on each device, a request split across
    them in order; ``max_batch`` must divide by their number, as the JAX
    predictor's by its mesh's devices."""

    def __init__(self, model, max_batch: int = 64, device="cuda",
                 fused: bool = False, quantize: str | None = None,
                 devices=None):
        devices = [resolve_device(d) for d in (devices or [device])]
        if max_batch % len(devices):
            raise ValueError(
                f"max_batch {max_batch} must divide the {len(devices)} "
                "devices"
            )
        self.device = devices[0]
        models = [m.eval() for m in replicate(model, devices)]
        self.model = models[0]
        self.max_batch = max_batch
        forwards = models
        if quantize is not None and not fused:
            raise ValueError("quantize requires fused=True")
        if fused:
            factory = {
                None: export.fused_stgcn_predictor,
                "w8": export.quantized_stgcn_predictor,
                "w8a8": export.int8_stgcn_predictor,
            }.get(quantize, None)
            if factory is None:
                raise ValueError(
                    f"quantize must be None, 'w8' (int8 weights) or "
                    f"'w8a8' (int8 weights+activations), got {quantize!r}"
                )
            forwards = [factory(m, device=d) for m, d in zip(models, devices)]
        self._forward = forwards[0]
        self._replicas = (Replicas(forwards, devices) if len(devices) > 1
                          else None)

    @classmethod
    def from_checkpoint(cls, model, checkpoint_dir: str, max_batch: int = 64,
                        device="cuda", fused: bool = False,
                        quantize: str | None = None,
                        devices=None) -> "Predictor":
        """A predictor over ``model`` holding the parameters and BatchNorm
        statistics of the latest checkpoint in ``checkpoint_dir``, as the
        port's trainers write them; ``FileNotFoundError`` when there is
        none. The JAX ``from_checkpoint`` also takes ``sample_input``,
        which flax needs to initialize the model and a torch module does
        not; ``devices`` takes the place of its ``mesh``. ``fused`` and
        ``quantize`` select the predictor as in the constructor (the JAX
        ``from_checkpoint`` serves the unfolded model alone)."""
        device = resolve_device(device)
        ckpt_lib.restore_latest_for_eval(model, checkpoint_dir)
        return cls(model, max_batch=max_batch, device=device, fused=fused,
                   quantize=quantize, devices=devices)

    def __call__(self, x) -> np.ndarray:
        """Predict class probabilities for ``(n, 3, T, V, M)`` clips,
        ``n <= max_batch``. The JAX predictor pads every request to
        ``max_batch`` so that XLA compiles one shape; eager PyTorch runs
        each size as it comes, so nothing is padded here.

        Under a profiler the request's phases are spans
        (:func:`..tracing.span`): ``serve.input`` (the host array to the
        device), ``serve.forward`` and ``serve.output`` (the softmax, back
        to a host array)."""
        replicas = self._replicas
        with torch.inference_mode():
            with span("serve.input"):
                x = np.asarray(x, np.float32)
                if len(x) > self.max_batch:
                    raise ValueError(
                        f"batch {len(x)} exceeds max_batch {self.max_batch}"
                    )
                x = (torch.from_numpy(x).to(self.device) if replicas is None
                     else replicas.split(x))
            with span("serve.forward"):
                logits = (self._forward(x) if replicas is None
                          else replicas.forward(x))
            with span("serve.output"):
                if replicas is not None:  # each replica's rows, in order
                    logits = torch.cat([out.cpu() for out in logits])
                return torch.softmax(logits.float(), dim=-1).cpu().numpy()
