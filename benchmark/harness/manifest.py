"""Find a cell's files by the names in ``BENCHMARK.json``.

Every configuration, cell, driver, model builder, reference, count and
metric is a file of its own under ``benchmark/``, named as the manifest
names it: ``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py``, ``models/<config>.py``, ``reference/<config>.py``,
``counts/<op>.py`` and ``metrics/<metric>.py``. A new cell or metric is new
files and a new entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    if not MANIFEST.exists():
        raise FileNotFoundError(f"{MANIFEST} is missing")
    return load_json(MANIFEST)


def workload(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{check_name(name)}.json")


def config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{check_name(name)}.json")


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (kept in ``sys.modules``
    under ``bench_<kind>_<name>``, dots as underscores)."""
    key = f"bench_{kind}_{check_name(name)}".replace(".", "_").replace(
        "-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_for(cell: str, kind: str, bench: dict | None = None) -> list:
    """The entries of ``kind`` (``end_to_end`` or ``per_layer``) that the
    manifest has ``cell`` report: those without a ``workloads`` list and
    those whose list names it."""
    bench = bench or manifest()
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def cell_entry(cell: str, bench: dict | None = None) -> dict:
    bench = bench or manifest()
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in {MANIFEST}")
