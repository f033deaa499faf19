"""Checkpoints with resume.

Counterpart of ``skeleton_action_recognition_tpu/train/checkpoint.py``:
the same ``<directory>/<step>/`` layout and ``max_to_keep=5`` retention,
with ``torch.save`` in place of Orbax. A checkpoint holds the model's and
the optimizer's ``state_dict``, the optimizer's step count and the
``extra`` dict (the trainer keeps the epoch there). Orbax checkpoints of
the JAX package do not load here; their weights go through
:mod:`..interop`.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import torch

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        if any(ch in self.directory for ch in "[]*?"):
            # the JAX package's Orbax checkpoints break under glob
            # metacharacters; the port refuses them too, so that one run
            # directory serves both
            raise ValueError(
                "checkpoint directory must not contain glob "
                f"metacharacters ([]*?): {self.directory!r}"
            )
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit()
            and os.path.exists(os.path.join(self.directory, d, _FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, optimizer=None,
             extra: Optional[dict] = None) -> str:
        """Write checkpoint ``step`` (replacing one of the same step) and
        drop the oldest beyond ``max_to_keep``."""
        payload = {
            "model": model.state_dict(),
            "optimizer": (
                optimizer.state_dict() if optimizer is not None else None
            ),
            "step": (
                optimizer.param_groups[0].get("count")
                if optimizer is not None else None
            ),
            "extra": extra,
        }
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.{os.getpid()}.tmp")
        os.makedirs(tmp, exist_ok=True)
        torch.save(payload, os.path.join(tmp, _FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return final

    def _load(self, step: int) -> dict:
        return torch.load(
            os.path.join(self.directory, str(step), _FILE),
            map_location="cpu", weights_only=True,
        )

    def restore(self, model, optimizer=None, step: Optional[int] = None
                ) -> Tuple[Optional[dict], Optional[int]]:
        """Load checkpoint ``step`` (default: the latest) into ``model`` and
        ``optimizer`` in place; returns ``(extra, step)``, or ``(None,
        None)`` and leaves both as they are when there is none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        payload = self._load(step)
        model.load_state_dict(payload["model"])
        if optimizer is not None and payload["optimizer"] is not None:
            optimizer.load_state_dict(payload["optimizer"])
        return payload["extra"], step

    def restore_for_eval(self, model, step: Optional[int] = None
                         ) -> Optional[int]:
        """Load only the model's state (parameters and BatchNorm
        statistics), whatever optimizer wrote the checkpoint; returns the
        step, or None when there is no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is not None:
            model.load_state_dict(self._load(step)["model"])
        return step


def restore_latest_for_eval(model, directory: str) -> int:
    """Load the parameters and statistics of the latest checkpoint in
    ``directory`` into ``model``; returns its step. ``FileNotFoundError``
    when there is none (the JAX evaluation CLIs' and predictor's error)."""
    step = CheckpointManager(directory).restore_for_eval(model)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    return step
