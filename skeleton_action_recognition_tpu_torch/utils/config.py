"""Config plumbing: ``config.yaml``, run names, source snapshots.

Counterpart of ``skeleton_action_recognition_tpu/utils/config.py``: the
argparse namespace is dumped as ``config.yaml`` into the log dir, the run
directory is named after the hyperparameters, and the model's source file
is copied beside it. The card's machine has no PyYAML, so the dump is
written here: a flat mapping of scalars and lists, keys sorted as
``yaml.dump`` sorts them, strings single-quoted.
"""

from __future__ import annotations

import inspect
import math
import os
import shutil
from typing import Iterable


def run_name_from_args(
    args_dict: dict,
    exclude: Iterable[str] = (),
    notes: str = "",
) -> str:
    """Reference-style run name: the hyperparameter dict's ``str`` with
    spaces and quotes removed and commas as dashes, glob metacharacters
    stripped (they break checkpoint paths)."""
    params = {
        k: v for k, v in args_dict.items() if k not in set(exclude)
    }
    name = (
        str(params)
        .replace(" ", "")
        .replace("'", "")
        .replace(",", "-")[1:-1]
    )
    if notes:
        name += "-" + notes
    for ch in "[]*?":
        name = name.replace(ch, "")
    return name


def _yaml_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, _, exponent = text.partition("e")
        if exponent and "." not in mantissa:  # YAML 1.1 floats need a dot
            text = f"{mantissa}.0e{exponent}"
        return text
    return "'" + str(value).replace("'", "''") + "'"


def to_yaml(args_dict: dict) -> str:
    """YAML text of a flat mapping of scalars and lists of scalars."""
    lines = []
    for key in sorted(args_dict):
        value = args_dict[key]
        if isinstance(value, (list, tuple)):
            items = ", ".join(_yaml_scalar(v) for v in value)
            lines.append(f"{key}: [{items}]")
        else:
            lines.append(f"{key}: {_yaml_scalar(value)}")
    return "\n".join(lines) + "\n"


def save_arg(args_dict: dict, log_dir: str) -> str:
    """Dump the config dict as ``config.yaml`` in the log dir."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(to_yaml(args_dict))
    return path


def snapshot_sources(log_dir: str, objects) -> None:
    """Copy the defining source file of each object into the log dir."""
    os.makedirs(log_dir, exist_ok=True)
    for obj in objects:
        shutil.copy2(inspect.getfile(obj), log_dir)
