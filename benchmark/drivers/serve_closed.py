"""Closed-loop serving: one client sends requests back to back, each a host
float32 array of ``request`` clips from a seeded pool of ``pool`` arrays,
taken in a seeded order. A request is timed from handing its array to the
predictor until its probabilities are a host array.

Every answer of the window is kept with the pool entry it answered. After
the window the program is freed, the reference computes each pool entry's
probabilities once, and every answer is compared with its entry's: the
widest gap of a log-probability, over every clip and class.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from harness import inputs, manifest, trace

LOG_FLOOR = 1e-30


class Session:
    unit = "request"

    def __init__(self, cell):
        self.cell = cell
        config, params, device = cell.config, cell.params, cell.device
        self.builder = manifest.module("models", config["name"])
        self.reference = manifest.module("reference", config["name"])
        g = inputs.generator(cell.seed, inputs.DATA_STREAM, device)
        weights = self.builder.make_weights(config, cell.seed, device)
        calibration = self.builder.make_clips(config, params["request"], g,
                                              device)
        weights = self.reference.calibrate_statistics(config, weights,
                                                      calibration)
        del calibration
        n = params["request"]
        self.pool = [self.builder.make_clips(config, n, g, device).cpu()
                     .numpy() for _ in range(params["pool"])]
        self.order = torch.randperm(len(self.pool), generator=g,
                                    device=device).tolist()
        self.weights = {k: v.cpu() for k, v in weights.items()}
        self.predictor = self.builder.build_predictor(config, params, weights,
                                                      device)
        del weights
        self.answers = []
        for i in range(params["warmup_requests"]):
            self.predictor(self.pool[self.order[i % len(self.order)]])
        self.sent = 0

    def window(self, seconds, traced):
        """Requests until ``seconds`` have passed on the host's clock:
        ``{"count", "clips", "failed", "latencies_s", "window_s"}``."""
        self.cell.synchronize()
        latencies, count, failed = [], 0, 0
        start = time.perf_counter()
        with trace.span("bench.window", traced):
            while True:
                k = self.order[(self.sent + count) % len(self.order)]
                t = time.perf_counter()
                try:
                    with trace.span("bench.request", traced):
                        probs = self.predictor(self.pool[k])
                    self.answers.append((k, probs))
                except Exception:  # a request that fails counts as failed
                    failed += 1
                latencies.append(time.perf_counter() - t)
                count += 1
                if time.perf_counter() - start >= seconds:
                    break
        window_s = time.perf_counter() - start
        self.sent += count
        return {"count": count, "failed": failed,
                "clips": (count - failed) * self.cell.params["request"],
                "latencies_s": latencies, "window_s": window_s}

    def release(self):
        del self.predictor
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_probabilities(self, control=None):
        device = self.cell.device
        weights = {k: v.to(device) for k, v in self.weights.items()}
        return {k: self.reference.probabilities(
            self.cell.config, weights,
            torch.from_numpy(self.pool[k]).to(device), control).cpu()
            .numpy() for k in sorted({k for k, _ in self.answers})}

    def check(self) -> dict:
        if not self.answers:
            return {"logprob_gap": math.inf}
        want = self.reference_probabilities()
        return {"logprob_gap": max(
            logprob_gap(got, want[k]) for k, got in self.answers)}

    def flops_per_unit(self) -> float:
        return float(self.builder.request_flops(self.cell.config,
                                                self.cell.params))


def logprob_gap(got, want) -> float:
    """The widest ``|log p - log p_ref|`` over every clip and class; any
    non-finite probability reads infinite."""
    got = np.asarray(got, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.abs(np.log(np.maximum(got, LOG_FLOOR))
                        - np.log(np.maximum(want.astype(np.float64),
                                            LOG_FLOOR))).max())


def setup(cell):
    return Session(cell)
