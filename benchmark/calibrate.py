"""Readings that the limits of a cell's comparison are set from, on the
machine it starts on (not part of a benchmark run):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control fp8] [--control-seeds ...] \
        [--fault half_batch|unchanged|altered_answer] [--fault-seeds ...]

In one process, for each ``--seeds`` seed: the cell's set-up (the
program's first steps; for serving, ``--window`` seconds of requests), the
program freed, the reference, and the compared numbers (the lower
readings). For each ``--control-seeds`` seed: the reference computed in
the lower precision ``--control`` in the program's place (the upper
readings). For each ``--fault-seeds`` seed: the program with the fault
planted. One JSON line each, then the largest reading of each number by
kind.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]


def numbers_of(driver, session, kind, control):
    """The compared numbers of one set-up ``session`` (program freed), and
    what lies behind them: the program's against the reference, or for a
    control the reference in ``control``'s precision against the
    reference."""
    if session.unit == "step":
        from harness import compare

        want = session.reference_readings()
        got = (session.reference_readings(control) if kind == "control"
               else session.readings)
        return (compare.training_numbers(got, want),
                compare.training_details(got, want))
    if kind != "control":
        return session.check(), None
    want = session.reference_probabilities()
    got = session.reference_probabilities(control)
    return {"logprob_gap": max(driver.logprob_gap(got[k], want[k])
                               for k in want)}, None


def plant(builder, fault):
    """Wrap ``builder``'s program so that it runs with ``fault``."""
    import numpy as np

    if fault == "half_batch":
        build = builder.build_train

        def half(config, params, weights, device):
            model, opt, step = build(
                config, {**params, "batch": params["batch"] // 2}, weights,
                device)
            return model, opt, lambda x, y: step(x[:len(x) // 2],
                                                 y[:len(y) // 2])

        builder.build_train = half
    elif fault == "unchanged":
        build = builder.build_train

        def frozen(config, params, weights, device):
            model, opt, step = build(config, params, weights, device)
            opt.step = lambda closure=None: None
            return model, opt, step

        builder.build_train = frozen
    elif fault == "altered_answer":
        build = builder.build_predictor

        def altered(config, params, weights, device):
            predictor = build(config, params, weights, device)

            def call(x):
                p = np.array(predictor(x))
                p[0] = np.roll(p[0], 1)
                return p

            return call

        builder.build_predictor = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", default=None)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--window", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", type=json.loads, default=None,
                   help="JSON {config: {...}, params: {...}}: a smaller "
                   "cell, for a run on the CPU")
    args = p.parse_args(argv)

    import torch

    from harness import manifest, runner

    cell0 = runner.Cell(args.workload, 0, args.device, args.overrides)
    runner.set_precision(cell0.params)
    driver = manifest.module("drivers", cell0.workload["driver"])
    builder = manifest.module("models", cell0.config["name"])
    plans = ([("program", s) for s in args.seeds]
             + [("control", s) for s in args.control_seeds]
             + [("fault", s) for s in args.fault_seeds])
    worst, planted = {}, False
    for kind, seed in plans:
        if kind == "fault" and not planted:  # the faults' seeds come last
            plant(builder, args.fault)
            planted = True
        t = time.perf_counter()
        cell = runner.Cell(args.workload, seed, args.device, args.overrides)
        session = driver.setup(cell)
        if session.unit == "request":
            session.window(args.window, False)
        session.release()
        numbers, details = numbers_of(driver, session, kind, args.control)
        label = {"program": "program", "control": f"control_{args.control}",
                 "fault": f"fault_{args.fault}"}[kind]
        print(json.dumps({"workload": args.workload, "kind": label,
                          "seed": seed, "numbers": numbers,
                          "details": details,
                          "seconds": time.perf_counter() - t}), flush=True)
        for k, v in numbers.items():
            key = (label, k)
            worst[key] = max(worst.get(key, 0.0), v) if kind != "control" \
                else min(worst.get(key, float("inf")), v)
        del session
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "summary": {
        f"{label}.{k}": v for (label, k), v in worst.items()}}), flush=True)


if __name__ == "__main__":
    main()
