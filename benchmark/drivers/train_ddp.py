"""Closed-loop data-parallel training: ``params["ranks"]`` processes, one
card each, every one running the configuration's training step on its own
pool of ``params["batch"]`` clips, the gradients and BatchNorm moments
summed over the ranks by the port's data parallelism
(``train.steps.make_train_step(..., dp=parallel.sharding.DataParallel())``,
``parallel.distributed.global_means``) over ``params["backend"]`` (NCCL
between cards, gloo on the CPU).

Rank 0 is the runner's process; it starts ranks 1 and up as
``python3 benchmark/drivers/train_ddp.py --rank R ...`` and joins them at
``tcp://127.0.0.1:<free port>``. Each rank's pool is seeded from (seed,
rank); the weights from the seed alone, then rank 0's are broadcast. Every
rank runs the first ``check_steps`` steps, ``warmup_steps`` more, then the
window: before each step rank 0 tells the others, over a host-side gloo
group, whether to take it, so that every rank takes the same steps; at
the end they compare their counts. A rank that dies or stalls fails the
run within ``params["timeout_s"]`` (the groups' timeout), and rank 0 also
fails at once when a rank's process has ended during the window.

The record counts every rank's clips; ``flops_per_unit`` is one rank's
step, so that ``train_mfu`` stays a one-card share. Rank 0's readings
(each step's global loss, the first summed gradient per leaf, each leaf's
change) are compared with the reference's step over the global batch, the
ranks' batches laid end to end in rank order.

``params["fault"] = "local_gradients"`` plants a fault of the mechanism:
rank 0 takes part in the gradient all-reduce but keeps its own gradients
(a run with it must not be correct).
"""

from __future__ import annotations

import argparse
import datetime
import gc
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(BENCH_DIR)]

from harness import compare, inputs, manifest, runner, trace  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_generator(seed, rank, device) -> torch.Generator:
    """The generator of rank ``rank``'s pool: a stream of its own for each
    (seed, rank)."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) * 4 + inputs.DATA_STREAM) * 16 + rank)
                  % (2**63))
    return g


def rank_batches(cell, builder, rank, n, device) -> list:
    """The first ``n`` batches of rank ``rank``'s pool."""
    g = rank_generator(cell.seed, rank, device)
    batch, config = cell.params["batch"], cell.config
    return [(builder.make_clips(config, batch, g, device),
             inputs.one_hot_labels(batch, config["num_classes"], g, device))
            for _ in range(n)]


def cpu_list(text: str) -> set:
    """The CPUs of a sysfs list such as ``0-15,32-47``."""
    cpus = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def local_cpus(card: int, allowed: set) -> frozenset:
    """The CPUs of ``allowed`` on the card's own socket (sysfs
    ``local_cpulist`` of its PCI device), or all of ``allowed`` where that
    cannot be read."""
    props = torch.cuda.get_device_properties(card)
    try:
        address = (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
                   f"{props.pci_device_id:02x}.0")
        with open(f"/sys/bus/pci/devices/{address}/local_cpulist") as f:
            return frozenset(cpu_list(f.read()) & allowed) or frozenset(
                allowed)
    except (AttributeError, OSError, ValueError):
        return frozenset(allowed)


def pin(rank: int, world: int) -> None:
    """Give this rank its own share of the CPUs on its card's socket and as
    many torch threads: the ranks that share a socket split its CPUs in
    rank order. Unpinned, four ranks on one host contend for every core
    (each with torch's default of a thread a core) wherever the scheduler
    puts them, which moved whole runs by ~5% in clips/s."""
    allowed = os.sched_getaffinity(0)
    groups = [local_cpus(r, allowed) for r in range(world)]
    peers = [r for r in range(world) if groups[r] == groups[rank]]
    cpus = sorted(groups[rank])
    share = len(cpus) // len(peers)
    if share < 1:
        return
    start = peers.index(rank) * share
    mine = cpus[start:start + share]
    os.sched_setaffinity(0, mine)
    torch.set_num_threads(len(mine))
    print(f"rank {rank}: CPUs {mine[0]}-{mine[-1]} of {len(allowed)}",
          file=sys.stderr)


def keep_local_gradients(dp) -> None:
    """Rank 0 all-reduces a copy of its gradients and keeps its own (the
    fault ``local_gradients``); the collective still pairs with the
    others'."""
    reduce = dp.all_reduce_gradients

    def local(module):
        saved = [p.grad.clone() for p in module.parameters()
                 if p.grad is not None]
        reduce(module)
        grads = [p for p in module.parameters() if p.grad is not None]
        for p, g in zip(grads, saved):
            p.grad.copy_(g)

    dp.all_reduce_gradients = local


class Replica:
    """One rank's program: the model holding the seeded weights (rank 0's,
    broadcast), TFSGD at the cell's rate, the data-parallel step at the
    global batch, and the rank's pool. Joins the process group first."""

    def __init__(self, cell, rank, init_method):
        from skeleton_action_recognition_tpu_torch.parallel.sharding import (
            DataParallel,
        )
        from skeleton_action_recognition_tpu_torch.train import optim, steps

        params, device = cell.params, cell.device
        world = params["ranks"]
        timeout = datetime.timedelta(seconds=params["timeout_s"])
        if device.type == "cuda":  # card ``rank``
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            pin(rank, world)
        dist.init_process_group(params["backend"], init_method=init_method,
                                rank=rank, world_size=world,
                                timeout=timeout)
        self.control = dist.new_group(backend="gloo", timeout=timeout)
        self.cell, self.rank, self.world = cell, rank, world
        self.builder = manifest.module("models", cell.config["name"])
        weights = self.builder.make_weights(cell.config, cell.seed, device)
        self.pool = rank_batches(cell, self.builder, rank, params["pool"],
                                 device)
        self.model = self.builder.model(cell.config, params, weights, device)
        dp = DataParallel()
        dp.broadcast_module(self.model)
        if rank == 0 and params.get("fault") == "local_gradients":
            keep_local_gradients(dp)
        self.optimizer = optim.TFSGD(self.model.parameters(), params["lr"],
                                     momentum=params["momentum"],
                                     nesterov=True)
        step = steps.make_train_step(self.model, self.optimizer,
                                     params["batch"] * world,
                                     params.get("l2_weight", 0.0), dp=dp)
        self.step = lambda x, y: step(x, y, False)
        self.weights = ({k: v.cpu() for k, v in weights.items()}
                        if rank == 0 else None)
        self.taken = 0

    def take(self):
        """One step on the pool's next batch."""
        x, y = self.pool[self.taken % len(self.pool)]
        self.taken += 1
        return self.step(x, y)

    def signal(self, go: bool) -> bool:
        """Rank 0's word on the next step, on every rank."""
        flag = torch.tensor([int(go)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.control)
        return bool(flag.item())

    def agree(self, count: int) -> None:
        """Raise unless every rank took ``count`` window steps."""
        lo = torch.tensor([count], dtype=torch.int64)
        hi = lo.clone()
        dist.all_reduce(lo, dist.ReduceOp.MIN, group=self.control)
        dist.all_reduce(hi, dist.ReduceOp.MAX, group=self.control)
        if lo.item() != hi.item():
            raise RuntimeError(f"the ranks took {lo.item()} to {hi.item()} "
                               "window steps")

    def close(self):
        del self.model, self.optimizer, self.step, self.pool
        gc.collect()
        dist.destroy_process_group()


class Session:
    unit = "step"

    def __init__(self, cell):
        self.cell = cell
        params = cell.params
        self.reference = manifest.module("reference", cell.config["name"])
        init_method = f"tcp://127.0.0.1:{free_port()}"
        self.children = spawn(cell, init_method)
        try:
            self.replica = Replica(cell, 0, init_method)
            self.readings = self._first_steps(params["check_steps"])
            for _ in range(params["warmup_steps"]):
                self.replica.take()
        except BaseException:
            stop(self.children)
            raise
        self.stopped = False

    def _first_steps(self, n):
        replica, device = self.replica, self.cell.device
        losses, grads = [], None
        for _ in range(n):
            losses.append(replica.take()["loss"])
            if grads is None:
                grads = replica.builder.first_gradients(
                    replica.model, replica.optimizer, self.cell.params)
        with torch.no_grad():
            deltas = {
                name: (p.detach() - replica.weights[name].to(device)).norm()
                .item() for name, p in replica.model.named_parameters()}
        return {"losses": [float(v) for v in losses], "grad_tensors": grads,
                "grads": {k: v.norm().item() for k, v in grads.items()},
                "deltas": deltas}

    def window(self, seconds, traced):
        """Steps until ``seconds`` have passed on the host's clock (at least
        one), every rank taking each, then a synchronize: ``{"count",
        "clips", "window_s"}``, the clips of every rank."""
        replica = self.replica
        self.cell.synchronize()
        count, start = 0, time.perf_counter()
        with trace.span("bench.window", traced):
            while True:
                ended = [p.returncode for p in self.children
                         if p.poll() is not None]
                if ended:
                    raise RuntimeError(f"a rank ended during the window "
                                       f"(exit codes {ended})")
                go = count == 0 or time.perf_counter() - start < seconds
                if not replica.signal(go):
                    self.stopped = True
                    break
                with trace.span("bench.step", traced):
                    replica.take()
                count += 1
            self.cell.synchronize()
        window_s = time.perf_counter() - start
        replica.agree(count)
        return {"count": count,
                "clips": count * self.cell.params["batch"] * replica.world,
                "window_s": window_s}

    def release(self):
        if not self.stopped:  # set-up alone (calibration): no window ran
            self.replica.signal(False)
            self.replica.agree(0)
        self.replica.close()
        codes = stop(self.children, self.cell.params["timeout_s"])
        if any(codes):
            raise RuntimeError(f"ranks 1 and up exited with {codes}")
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, control=None):
        """The reference's first steps over the global batches: each step's
        batches of every rank, in rank order."""
        cell, n = self.cell, self.cell.params["check_steps"]
        builder = manifest.module("models", cell.config["name"])
        ranks = [rank_batches(cell, builder, r, n, cell.device)
                 for r in range(cell.params["ranks"])]
        batches = [(torch.cat([b[i][0] for b in ranks]),
                    torch.cat([b[i][1] for b in ranks])) for i in range(n)]
        del ranks
        params = {**cell.params,
                  "batch": cell.params["batch"] * cell.params["ranks"]}
        return self.reference.train_readings(
            cell.config, params, self.replica.weights, batches,
            control=control)

    def check(self) -> dict:
        return compare.training_numbers(self.readings,
                                        self.reference_readings())

    def flops_per_unit(self) -> float:
        builder = manifest.module("models", self.cell.config["name"])
        return float(builder.step_flops(self.cell.config, self.cell.params))


def spawn(cell, init_method) -> list:
    """Ranks 1 and up, each in a process of its own; their output goes to
    standard error."""
    overrides = {"config": cell.config, "params": cell.params}
    return [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--rank", str(rank), "--init", init_method, "--workload", cell.name,
         "--seed", str(cell.seed), "--device", cell.device.type,
         "--overrides", json.dumps(overrides)],
        stdout=2, cwd=str(ROOT))
        for rank in range(1, cell.params["ranks"])]


def stop(children, timeout=0.0) -> list:
    """The exit codes of ``children``, waiting up to ``timeout`` seconds
    for each, then killing what still runs."""
    codes = []
    for p in children:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def setup(cell):
    return Session(cell)


def rank_main(argv=None) -> int:
    """One rank above 0: set up, follow rank 0's word step by step, agree
    on the count, leave."""
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--overrides", type=json.loads, required=True)
    args = p.parse_args(argv)
    cell = runner.Cell(args.workload, args.seed, args.device, args.overrides)
    runner.set_precision(cell.params)
    replica = Replica(cell, args.rank, args.init)
    for _ in range(cell.params["check_steps"] + cell.params["warmup_steps"]):
        replica.take()
    count = 0
    while replica.signal(False):
        replica.take()
        count += 1
    cell.synchronize()
    replica.agree(count)
    replica.close()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
