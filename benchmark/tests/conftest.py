"""The benchmark's own tests: the repository root and ``benchmark/`` on the
path, as ``benchmark/run.py`` puts them."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "benchmark")):
    if path not in sys.path:
        sys.path.insert(0, path)
