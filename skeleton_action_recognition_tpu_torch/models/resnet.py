"""The spectrogram trainer's ``--model-type resnet`` (its default): the
VirtualRadar + ResNet-18 classifier of :mod:`.spectrogram`, as in the JAX
package's ``models/resnet.py``."""

from skeleton_action_recognition_tpu_torch.models.spectrogram import (  # noqa: F401
    Model,
)
