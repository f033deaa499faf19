"""Serving: a softmax predictor over a model in eval mode.

Counterpart of ``skeleton_action_recognition_tpu/serving.py``'s unsharded
``Predictor``, with its ``from_checkpoint``. For the stock ST-GCN,
:mod:`.models.export` also provides the folded predictors (BatchNorms and
the adjacency stack folded into the products, in bfloat16, W8 or W8A8):
pass ``fused=True`` and ``quantize``.
"""

from __future__ import annotations

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.models import export
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    resolve_device,
)
from skeleton_action_recognition_tpu_torch.train import checkpoint as ckpt_lib


class Predictor:
    """Class probabilities for batches of up to ``max_batch`` clips, on
    ``device`` (the CUDA card unless the caller asks for the CPU; without a
    card, ``"cuda"`` raises).

    ``fused=True`` serves the folded predictor of the stock ST-GCN
    (:mod:`.models.export`; any other model raises ``ValueError``) in
    bfloat16, or with ``quantize='w8'`` (int8 weights) or ``'w8a8'`` (int8
    weights and activations). It is not the model's ``fused_sgcn`` option,
    which runs the unfolded model's spatial conv through the CUDA kernel:
    the folded predictors run no kernel of the port."""

    def __init__(self, model, max_batch: int = 64, device="cuda",
                 fused: bool = False, quantize: str | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch
        self._forward = self.model
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
            self._forward = factory(self.model, device=self.device)

    @classmethod
    def from_checkpoint(cls, model, checkpoint_dir: str, max_batch: int = 64,
                        device="cuda", fused: bool = False,
                        quantize: str | None = None) -> "Predictor":
        """A predictor over ``model`` holding the parameters and BatchNorm
        statistics of the latest checkpoint in ``checkpoint_dir``, as the
        port's trainers write them; ``FileNotFoundError`` when there is
        none. The JAX ``from_checkpoint`` also takes ``sample_input``,
        which flax needs to initialize the model and a torch module does
        not, and ``mesh``: serving over several devices is not ported.
        ``fused`` and ``quantize`` select the predictor as in the
        constructor (the JAX ``from_checkpoint`` serves the unfolded model
        alone)."""
        device = resolve_device(device)
        ckpt_lib.restore_latest_for_eval(model, checkpoint_dir)
        return cls(model, max_batch=max_batch, device=device, fused=fused,
                   quantize=quantize)

    def __call__(self, x) -> np.ndarray:
        """Predict class probabilities for ``(n, 3, T, V, M)`` clips,
        ``n <= max_batch``. The JAX predictor pads every request to
        ``max_batch`` so that XLA compiles one shape; eager PyTorch runs
        each size as it comes, so nothing is padded here."""
        x = np.asarray(x, np.float32)
        if len(x) > self.max_batch:
            raise ValueError(
                f"batch {len(x)} exceeds max_batch {self.max_batch}"
            )
        with torch.inference_mode():
            logits = self._forward(torch.from_numpy(x).to(self.device))
            return torch.softmax(logits.float(), dim=-1).cpu().numpy()
