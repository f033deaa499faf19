"""Model zoo (PyTorch): the counterparts of the JAX package's models.

* :mod:`.stgcn`        — 10-block ST-GCN
* :mod:`.stgin`        — ST-GIN (Graph-Isomorphism spatial convs)
* :mod:`.stpgcn`       — ST-GCN + a projection graph conv
* :mod:`.stpgcnp`      — ST-GCN trunk + projection-pooling pyramid
* :mod:`.experimental` — the debug ST-GCN with per-timestep adjacency,
  GPool, SGCN, SGTACN and TemporalAttention
* :mod:`.spectrogram`  — VirtualRadar + ResNet-18 classifier
* :mod:`.resnet18`     — the width-parameterized ResNet-18
* :mod:`.lstm_sampler` — the LSTM temporal frame sampler
* :mod:`.gcn`, :mod:`.projection`, :mod:`.layers` — their layers

Each model module has a ``Model`` class, which the CLIs' ``--model <name>``
selects, as in JAX.
"""

from __future__ import annotations

import importlib
import pkgutil


def model_names() -> list[str]:
    """The names of the model modules, those with a ``Model`` class."""
    names = []
    for info in pkgutil.iter_modules(__path__):
        module = importlib.import_module(f"{__name__}.{info.name}")
        if hasattr(module, "Model"):
            names.append(info.name)
    return sorted(names)


def model_class(name: str):
    """``Model`` of ``models.<name>``; ``ValueError``, naming the models
    there are, for a name with no such class."""
    module_name = f"{__name__}.{name}"
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as err:
        if err.name != module_name:
            raise
        module = None
    cls = getattr(module, "Model", None)
    if cls is None:
        raise ValueError(
            f"--model {name!r} names no model: the models are "
            + ", ".join(model_names())
        )
    return cls
