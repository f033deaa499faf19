"""Serving: a softmax predictor over a model in eval mode.

Counterpart of ``skeleton_action_recognition_tpu/serving.py``'s unsharded,
unfolded ``Predictor``, with its ``from_checkpoint``.
"""

from __future__ import annotations

import numpy as np
import torch

from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    resolve_device,
)
from skeleton_action_recognition_tpu_torch.train import checkpoint as ckpt_lib


class Predictor:
    """Class probabilities for batches of up to ``max_batch`` clips, on
    ``device`` (the CUDA card unless the caller asks for the CPU; without a
    card, ``"cuda"`` raises)."""

    def __init__(self, model, max_batch: int = 64, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch = max_batch

    @classmethod
    def from_checkpoint(cls, model, checkpoint_dir: str, max_batch: int = 64,
                        device="cuda") -> "Predictor":
        """A predictor over ``model`` holding the parameters and BatchNorm
        statistics of the latest checkpoint in ``checkpoint_dir``, as the
        port's trainers write them; ``FileNotFoundError`` when there is
        none. The JAX ``from_checkpoint`` also takes ``sample_input``,
        which flax needs to initialize the model and a torch module does
        not, and ``mesh``: serving over several devices is not ported."""
        device = resolve_device(device)
        ckpt_lib.restore_latest_for_eval(model, checkpoint_dir)
        return cls(model, max_batch=max_batch, device=device)

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
