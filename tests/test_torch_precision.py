"""``ops/precision.py::einsum_f32``: the plain einsum's value and gradients,
with the caller's matmul precision left as it was found after the forward
and after the backward. (On the card, ``test_torch_radar_gpu.py`` and
``test_torch_stft_gpu.py`` hold the ops that use it to the same result with
TF32 on as off.)"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from skeleton_action_recognition_tpu_torch.ops.precision import einsum_f32

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

EQUATIONS = {
    "spline coefficients": ("qt,ntf->nqf", (8, 5), (2, 5, 6)),
    "upsampling": ("ot,nctem->ncoem", (7, 5), (2, 3, 5, 4, 2)),
    "stft frames": ("bsn,fn->bfs", (3, 4, 16), (6, 16)),
    "spline positions": ("njfq,jqr->njfr", (2, 3, 6, 8), (3, 8, 5)),
}


@pytest.fixture
def switch():
    """The legacy switch the port's trainers and ``chip_smoke.py`` set,
    restored after the test."""
    before = torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("allow", [False, True])
@pytest.mark.parametrize("name", list(EQUATIONS))
def test_matches_einsum_and_leaves_the_switch_as_found(switch, name, allow):
    equation, sa, sb = EQUATIONS[name]
    rng = np.random.default_rng(0)
    a0, b0 = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in (sa, sb))
    torch.backends.cuda.matmul.allow_tf32 = allow
    a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    out = einsum_f32(equation, a, b)
    assert torch.backends.cuda.matmul.allow_tf32 == allow
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(g)
    assert torch.backends.cuda.matmul.allow_tf32 == allow

    ar, br = a0.clone().requires_grad_(), b0.clone().requires_grad_()
    want = torch.einsum(equation, ar, br)
    want.backward(g)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a.grad, ar.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b.grad, br.grad, rtol=1e-6, atol=1e-6)


SETTINGS = {
    "legacy": "matmul.allow_tf32 = True",
    "high": "torch.set_float32_matmul_precision('high')",
    "medium": "torch.set_float32_matmul_precision('medium')",
    "per-backend": "matmul.fp32_precision = 'tf32'",
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_restores_a_setting_made_through_any_api(setting):
    """In a process of its own: torch remembers which API set the switch
    and refuses some reads after a mix, so a test here must not leave one
    behind for the tests after it."""
    code = (
        "import torch\n"
        "from skeleton_action_recognition_tpu_torch.ops.precision import (\n"
        "    einsum_f32, full_f32_matmul)\n"
        "matmul = torch.backends.cuda.matmul\n"
        f"{SETTINGS[setting]}\n"
        "def state():\n"
        "    out = []\n"
        "    for read in (lambda: matmul.allow_tf32,\n"
        "                 torch.get_float32_matmul_precision,\n"
        "                 lambda: getattr(matmul, 'fp32_precision', None)):\n"
        "        try:\n"
        "            out.append(read())\n"
        "        except RuntimeError:\n"
        "            out.append('refused')\n"
        "    return out\n"
        "before = state()\n"
        "with full_f32_matmul():\n"
        "    inside = state()\n"
        "a = torch.ones(2, 3, requires_grad=True)\n"
        "einsum_f32('ij,jk->ik', a, torch.ones(3, 4)).sum().backward()\n"
        "assert state() == before, (before, state())\n"
        "assert inside[0] is False or inside[2] == 'ieee', inside\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_restores_the_switch_when_the_contraction_raises(switch):
    torch.backends.cuda.matmul.allow_tf32 = True
    with pytest.raises(RuntimeError):
        einsum_f32("ij,jk->ik", torch.zeros(2, 3), torch.zeros(4, 5))
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_gradient_of_one_operand_only():
    a = torch.randn(4, 3, requires_grad=True)
    b = torch.randn(3, 5)
    einsum_f32("ij,jk->ik", a, b).sum().backward()
    torch.testing.assert_close(a.grad, torch.ones(4, 5) @ b.T)


@pytest.mark.parametrize("equation", ["ij,jk", "ii,ik->k", "ij,kl->ik",
                                      "...j,jk->...k"])
def test_refuses_what_its_backward_cannot_take(equation):
    with pytest.raises(ValueError):
        einsum_f32(equation, torch.zeros(3, 3), torch.zeros(3, 3))
