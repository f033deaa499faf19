"""The import check: JAX and the JAX package are found by whole top-level
names (the port's name begins with the JAX package's), and nothing the
benchmark runs loads them."""

import pathlib
import re
import subprocess
import sys

from harness import runner

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def test_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "skeleton_action_recognition_tpu",
              "skeleton_action_recognition_tpu.ops.graph",
              "skeleton_action_recognition_tpu_torch",
              "skeleton_action_recognition_tpu_torch.models.stgcn",
              "jaxtyping", "flaxen", "torch"]
    assert runner.banned_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "skeleton_action_recognition_tpu",
        "skeleton_action_recognition_tpu.ops.graph"]


def test_no_source_of_the_benchmark_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|"
        r"skeleton_action_recognition_tpu)(\s|\.|$)", re.M)
    for path in BENCH_DIR.rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module a run imports, at a tiny size on the CPU: the harness,
    the builders, drivers, references, metrics and the port's modules."""
    code = (
        "import sys, time; t0 = time.perf_counter();"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(BENCH_DIR)!r}];"
        "from harness import runner;"
        "runner.run_cell('stgcn_serve_folded_bf16_r64', 5, 0.2, False, t0,"
        " 'cpu', {'config': {'frames': 12},"
        " 'params': {'request': 2, 'pool': 2, 'warmup_requests': 1}});"
        "from harness import manifest;"
        "[manifest.module(k, n) for k, n in (('models', 'vradar_resnet18'),"
        " ('reference', 'vradar_resnet18'), ('drivers', 'train_closed'))];"
        "import skeleton_action_recognition_tpu_torch.models.spectrogram;"
        "print(runner.banned_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
