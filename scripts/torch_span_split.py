#!/usr/bin/env python3
"""The phase split of one benchmark cell on a CUDA card: the cell's
traced window, as ``benchmark/run.py --trace 1`` runs it, with its device
work put down to the port's spans (``benchmark/harness/spans.py``).

    python3 scripts/torch_span_split.py --workload <cell> --seed <n> \
        --seconds <s>

from the root of a checkout. Prints one JSON line, per unit (a train
step or a request): each span's device ms, work items, host ms and count;
the device ms of the work no span holds and its share of the busy time;
the phases' share of the busy time; the device ms launched inside any
``op.*`` span beside that of the kernels the cell's roofline readers
match by name (``KERNELS``, ``FOLLOWERS``); the names of the kernels
inside ``op.*`` spans; and the host-to-device copies' device ms.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "benchmark"
# kernels of the libraries and of torch itself: none may run inside op.*
LIBRARY = re.compile(r"cublas|cudnn|nvjet|cutlass|at::native|sm90_|gemm",
                     re.IGNORECASE)


def split(name, seed, seconds, device="cuda", overrides=None) -> dict:
    """The split of cell ``name``'s window (``overrides`` as
    ``harness.runner.Cell`` takes them)."""
    from harness import manifest, runner, spans, trace

    cell = runner.Cell(name, seed, device, overrides)
    runner.set_precision(cell.params)
    session = manifest.module("drivers", cell.workload["driver"]).setup(cell)
    cell.synchronize()
    with trace.profiler() as prof:
        record = session.window(seconds, True)
    events = prof.profiler.kineto_results.events()
    reduced = trace.reduce(events, record["window_s"])
    items, program_spans = spans.assign(events)
    owned = spans.attribute(items, program_spans)
    units = record["count"]
    busy = reduced["busy_s"]

    def per_unit(s):
        return s * 1e3 / units

    def of_busy(s):
        return s / busy if busy else None

    phases = sum(s["device_s"] for n, s in owned["spans"].items()
                 if n.startswith(spans.PHASES))
    op_s = sum(s["device_s"] for n, s in owned["spans"].items()
               if n.startswith(spans.OPS))
    in_ops = {}
    for kernel, s, owners in items:
        if any(o.startswith(spans.OPS) for o in owners):
            in_ops[kernel[:120]] = in_ops.get(kernel[:120], 0.0) + s
    roofline = 0.0
    for entry in manifest.metrics_for(name, "per_layer", manifest.manifest()):
        if entry["name"].endswith("_roofline"):
            reader = manifest.module("metrics", entry["name"])
            roofline += trace.kernel_seconds(
                reduced, reader.KERNELS, getattr(reader, "FOLLOWERS", ()))
    import torch

    return {
        "workload": name, "seed": seed, "unit": session.unit,
        "units": units, "window_s": record["window_s"],
        "device": (torch.cuda.get_device_name(cell.device)
                   if cell.device.type == "cuda" else "cpu"),
        "traced_ms_per_unit": record["window_s"] * 1e3 / units,
        "busy_ms_per_unit": per_unit(busy),
        "spans": {n: {"device_ms": per_unit(s["device_s"]),
                      "work": s["work"] / units,
                      "host_ms": per_unit(s["host_s"]),
                      "count": s["count"] / units}
                  for n, s in sorted(owned["spans"].items())},
        "unattributed_ms_per_unit": per_unit(owned["unattributed_s"]),
        "unattributed_work_per_unit": owned["unattributed_work"] / units,
        "unattributed_share_of_busy": of_busy(owned["unattributed_s"]),
        "phases_share_of_busy": of_busy(phases),
        "op_ms_per_unit": per_unit(op_s),
        "roofline_kernels_ms_per_unit": per_unit(roofline),
        "kernels_in_ops_ms_per_unit": {k: per_unit(s) for k, s in sorted(
            in_ops.items(), key=lambda kv: -kv[1])},
        "library_kernels_in_ops": sorted(k for k in in_ops
                                         if LIBRARY.search(k)),
        "memcpy_htod_ms_per_unit": per_unit(sum(
            s for k, s in reduced["by_name"].items()
            if k.startswith("Memcpy HtoD"))),
        "launches_per_unit": reduced["device_work"] / units,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    for path in (str(ROOT), str(BENCH_DIR)):
        if path not in sys.path:
            sys.path.insert(0, path)
    print(json.dumps(split(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
