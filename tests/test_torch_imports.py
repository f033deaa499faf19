"""The PyTorch port imports no jax, flax or optax, and nothing of the JAX
package: the machine with the card has none of them."""

import pathlib
import re
import subprocess
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = REPO_ROOT / "skeleton_action_recognition_tpu_torch"


def test_port_imports_with_jax_blocked():
    """Also blocks the two packages the card's machine lacks and the JAX
    package's helpers used: PyYAML and matplotlib."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'yaml', 'matplotlib',\n"
        "             'skeleton_action_recognition_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import skeleton_action_recognition_tpu_torch\n"
        "import skeleton_action_recognition_tpu_torch.models.stgcn\n"
        "import skeleton_action_recognition_tpu_torch.serving\n"
        "import skeleton_action_recognition_tpu_torch.ops.sgcn\n"
        "import skeleton_action_recognition_tpu_torch.ops.tconv\n"
        "import skeleton_action_recognition_tpu_torch.models.gcn\n"
        "import skeleton_action_recognition_tpu_torch.models.layers\n"
        "import skeleton_action_recognition_tpu_torch.interop\n"
        "import skeleton_action_recognition_tpu_torch.cli.main_gnn\n"
        "import skeleton_action_recognition_tpu_torch.data.pipeline\n"
        "import skeleton_action_recognition_tpu_torch.data.proto\n"
        "import skeleton_action_recognition_tpu_torch.data.streams\n"
        "import skeleton_action_recognition_tpu_torch.data.tfrecord\n"
        "import skeleton_action_recognition_tpu_torch.parallel.sharding\n"
        "import skeleton_action_recognition_tpu_torch.parallel.distributed\n"
        "import skeleton_action_recognition_tpu_torch.native\n"
        "import skeleton_action_recognition_tpu_torch.train.checkpoint\n"
        "import skeleton_action_recognition_tpu_torch.train.losses\n"
        "import skeleton_action_recognition_tpu_torch.train.metrics\n"
        "import skeleton_action_recognition_tpu_torch.train.optim\n"
        "import skeleton_action_recognition_tpu_torch.train.schedules\n"
        "import skeleton_action_recognition_tpu_torch.train.steps\n"
        "import skeleton_action_recognition_tpu_torch.utils.config\n"
        "import skeleton_action_recognition_tpu_torch.utils.confusion\n"
        "import skeleton_action_recognition_tpu_torch.utils.tb_writer\n"
        "import skeleton_action_recognition_tpu_torch.cli.main_spectrogram\n"
        "import skeleton_action_recognition_tpu_torch.models.resnet\n"
        "import skeleton_action_recognition_tpu_torch.models.resnet18\n"
        "import skeleton_action_recognition_tpu_torch.models.spectrogram\n"
        "import skeleton_action_recognition_tpu_torch.ops.radar\n"
        "import skeleton_action_recognition_tpu_torch.ops.resample\n"
        "import skeleton_action_recognition_tpu_torch.ops.stft\n"
        "import skeleton_action_recognition_tpu_torch.ops.stft_logmag\n"
        "import skeleton_action_recognition_tpu_torch.ops.virtual_radar\n"
        "import skeleton_action_recognition_tpu_torch.ops.precision\n"
        "import skeleton_action_recognition_tpu_torch.data\n"
        "import skeleton_action_recognition_tpu_torch.data.skeleton\n"
        "import skeleton_action_recognition_tpu_torch.data.rotation\n"
        "import skeleton_action_recognition_tpu_torch.data.preprocess\n"
        "import skeleton_action_recognition_tpu_torch.cli.data_gen\n"
        "import skeleton_action_recognition_tpu_torch.cli.evaluate\n"
        "import skeleton_action_recognition_tpu_torch.cli.ensemble\n"
        "import skeleton_action_recognition_tpu_torch.graphs\n"
        "import skeleton_action_recognition_tpu_torch.graphs.tools\n"
        "import skeleton_action_recognition_tpu_torch.ops.graph\n"
        "import skeleton_action_recognition_tpu_torch.models.projection\n"
        "import skeleton_action_recognition_tpu_torch.models.stgin\n"
        "import skeleton_action_recognition_tpu_torch.models.stpgcn\n"
        "import skeleton_action_recognition_tpu_torch.models.stpgcnp\n"
        "import skeleton_action_recognition_tpu_torch.models.experimental\n"
        "import skeleton_action_recognition_tpu_torch.models.lstm_sampler\n"
        "import skeleton_action_recognition_tpu_torch.models.export\n"
        "from skeleton_action_recognition_tpu_torch.models import (\n"
        "    model_names)\n"
        "assert {'stgcn', 'stgin', 'stpgcn', 'stpgcnp', 'experimental',\n"
        "        'spectrogram'} <= set(model_names())\n"
        "import chip_smoke\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_names_jax():
    """Catches imports inside functions too, which the import test above
    does not reach."""
    pattern = re.compile(
        r"^\s*(import|from)\s+"
        r"(jax|flax|optax|skeleton_action_recognition_tpu)\b", re.M
    )
    sources = list(PORT_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    offenders = [
        str(p.relative_to(REPO_ROOT)) for p in sources
        if pattern.search(p.read_text())
    ]
    assert len(sources) > 5 and offenders == []
