"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port (``skeleton_action_recognition_tpu_torch``). Set-up makes the
weights and inputs on the card from the seed and warms up the cell's
shapes; the window then measures for ``--seconds`` (``--trace 1``: under
the profiler, for at most the cell's ``trace_seconds``); the outputs of
the timed path are compared with the plain reference; the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics), ``device`` and, traced,
``breakdown``, then ``checks``, each compared number beside its limit,
which also close standard error.

Exits 2 and prints no result without as many CUDA cards as the cell asks
for, and 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache of the program at a fixed place inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv_compute"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare_environment():
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    for path in (str(ROOT), str(BENCH_DIR)):
        if path not in sys.path:
            sys.path.insert(0, path)


def main(argv=None) -> int:
    args = parse(argv)
    prepare_environment()
    from harness import manifest, runner

    chips = manifest.cell_entry(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), T0, "cuda", chips=chips)
    banned = runner.banned_modules(sys.modules)
    if banned:
        print(f"loaded in the run: {', '.join(banned)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])  # JSON has no infinity
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
