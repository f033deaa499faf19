"""Closed-loop training: back-to-back steps of the configuration's training
step over a pool of seeded batches made on the device.

Set-up builds the step once (model and optimizer), drives it through the
first ``check_steps`` steps on the pool's first batches (rows that all
differ), reads the program's side of the comparison from them (each
step's loss, the first gradient per leaf from the optimizer's state,
each leaf's change after the last), warms up ``warmup_steps`` more
and hands the same step to the window, which continues through the pool.
After the window the program is freed and the reference follows the same
first steps from the same weights on the same batches.
"""

from __future__ import annotations

import gc
import time

import torch

from harness import compare, inputs, manifest, trace


class Session:
    unit = "step"

    def __init__(self, cell):
        self.cell = cell
        config, params, device = cell.config, cell.params, cell.device
        self.builder = manifest.module("models", config["name"])
        self.reference = manifest.module("reference", config["name"])
        weights = self.builder.make_weights(config, cell.seed, device)
        g = inputs.generator(cell.seed, inputs.DATA_STREAM, device)
        batch = params["batch"]
        self.pool = [
            (self.builder.make_clips(config, batch, g, device),
             inputs.one_hot_labels(batch, config["num_classes"], g, device))
            for _ in range(params["pool"])
        ]
        self.model, self.optimizer, self.step = self.builder.build_train(
            config, params, weights, device)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        del weights
        self.readings = self._first_steps(params["check_steps"])
        for i in range(params["warmup_steps"]):
            self.step(*self.batch(params["check_steps"] + i))
        self.next = params["check_steps"] + params["warmup_steps"]

    def batch(self, i):
        return self.pool[i % len(self.pool)]

    def _first_steps(self, n):
        losses, grads = [], None
        for i in range(n):
            losses.append(self.step(*self.batch(i))["loss"])
            if grads is None:
                grads = self.builder.first_gradients(
                    self.model, self.optimizer, self.cell.params)
        device = self.cell.device
        with torch.no_grad():
            deltas = {
                name: (p.detach() - self.weights[name].to(device)).norm()
                .item() for name, p in self.model.named_parameters()}
        return {"losses": [float(v) for v in losses], "grad_tensors": grads,
                "grads": {k: v.norm().item() for k, v in grads.items()},
                "deltas": deltas}

    def window(self, seconds, traced):
        """Steps until ``seconds`` have passed on the host's clock, then a
        synchronize: ``{"count", "clips", "window_s"}``."""
        sync = self.cell.synchronize
        sync()
        count, start = 0, time.perf_counter()
        with trace.span("bench.window", traced):
            while True:
                with trace.span("bench.step", traced):
                    self.step(*self.batch(self.next + count))
                count += 1
                if time.perf_counter() - start >= seconds:
                    break
            sync()
        window_s = time.perf_counter() - start
        self.next += count
        return {"count": count, "clips": count * self.cell.params["batch"],
                "window_s": window_s}

    def release(self):
        del self.model, self.optimizer, self.step
        gc.collect()
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, control=None):
        n = self.cell.params["check_steps"]
        return self.reference.train_readings(
            self.cell.config, self.cell.params, self.weights,
            [self.batch(i) for i in range(n)], control=control)

    def check(self) -> dict:
        return compare.training_numbers(self.readings,
                                        self.reference_readings())

    def flops_per_unit(self) -> float:
        return float(self.builder.step_flops(self.cell.config,
                                             self.cell.params))


def setup(cell):
    return Session(cell)
