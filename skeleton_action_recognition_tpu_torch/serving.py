"""Serving: a softmax predictor over a model in eval mode.

Counterpart of ``skeleton_action_recognition_tpu/serving.py``'s unsharded,
unfolded ``Predictor``.
"""

from __future__ import annotations

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    resolve_device,
)


class Predictor:
    """Class probabilities for batches of up to ``max_batch`` clips, on
    ``device`` (the CUDA card unless the caller asks for the CPU; without a
    card, ``"cuda"`` raises)."""

    def __init__(self, model, max_batch: int = 64, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch

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
            logits = self.model(torch.from_numpy(x).to(self.device))
            return torch.softmax(logits.float(), dim=-1).cpu().numpy()
