"""One run of one cell: set up, measure, compare, report.

The cell's workload file names its configuration and driver; the driver
builds the program from the configuration's model builder and the
benchmark's seeded weights and inputs. Set-up ends when the driver hands
over a warm program; the window then runs for the given seconds (the
traced run: for at most the cell's ``trace_seconds``, under the profiler).
The device's peak memory is read over the window, before the program is
freed and the reference runs. The metrics the manifest gives the cell are
read by their own files; a per-layer metric whose reader finds nothing is
left out.
"""

from __future__ import annotations

import math
import time

import torch

from harness import manifest, trace

IMPORT_BANNED = ("jax", "jaxlib", "flax", "skeleton_action_recognition_tpu")


class Cell:
    """What a driver needs of the cell: its name, configuration (with its
    ``name``), parameters, seed and device."""

    def __init__(self, name, seed, device, overrides=None):
        overrides = overrides or {}
        self.name = name
        self.workload = manifest.workload(name)
        self.config = {**manifest.config(self.workload["config"]),
                       "name": self.workload["config"],
                       **overrides.get("config", {})}
        self.params = {**self.workload["params"],
                       **overrides.get("params", {})}
        self.limits = self.workload["limits"]
        self.seed = int(seed)
        self.device = torch.device(device)

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Run:
    """What a metric reader sees: the window's ``record`` (the driver's),
    the reduced ``trace`` (None untraced), the set-up seconds, the
    window's peak memory and the session (for its work counts)."""

    def __init__(self, cell, session, record, trace_summary, setup_s,
                 peak_bytes):
        self.cell, self.session, self.record = cell, session, record
        self.trace, self.setup_s, self.peak_bytes = (trace_summary, setup_s,
                                                     peak_bytes)


def banned_modules(modules) -> list:
    """The loaded modules whose top-level name is one of
    ``IMPORT_BANNED``, compared whole."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in IMPORT_BANNED)


def set_precision(params):
    tf32 = params.get("tf32", {})
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32.get("matmul", False))
    torch.backends.cudnn.allow_tf32 = bool(tf32.get("cudnn", True))


def run_cell(name, seed, seconds, traced, t0, device="cuda",
             overrides=None, chips=1) -> dict:
    """The result of one run of cell ``name`` (process started at ``t0`` on
    ``time.perf_counter``): the contract's keys, with ``checks`` last."""
    bench = manifest.manifest()
    cell = Cell(name, seed, device, overrides)
    set_precision(cell.params)
    session = manifest.module("drivers", cell.workload["driver"]).setup(cell)
    cell.synchronize()
    setup_s = time.perf_counter() - t0
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
    summary = None
    if traced:
        window = min(seconds, cell.workload.get("trace_seconds", seconds))
        with trace.profiler() as prof:
            record = session.window(window, True)
        summary = trace.read(prof, record["window_s"])
        del prof
    else:
        record = session.window(seconds, False)
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    run = Run(cell, session, record, summary, setup_s, peak)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for entry in manifest.metrics_for(name, kind, bench):
        value = manifest.module("metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    session.release()
    numbers = session.check()
    checks = {k: {"value": numbers[k], "limit": limit}
              for k, limit in cell.limits.items()}
    failed = record.get("failed", 0)
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    device_info = {
        "platform": "gpu" if cuda else cell.device.type,
        "kind": torch.cuda.get_device_name(cell.device) if cuda else "cpu",
        "count": chips,
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": record["count"],
              "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result
