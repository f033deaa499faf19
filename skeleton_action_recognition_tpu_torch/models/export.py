"""Folded serving predictors of the stock ST-GCN.

Counterpart of ``skeleton_action_recognition_tpu/models/export.py``. In
eval mode every BatchNorm is a per-channel affine and the adjacency stack
is a constant, so each block's spatial conv

    ``out[t, w, co] = sum_k sum_v A[k, v, w] (x[t, v, :] @ W_k + b_k)[co]``

folds into one dense product over joint-channel features:

    ``Wf[(v, ci), (w, co)] = sum_k A[k, v, w] * W[ci, k, co]``
    ``out[t] = relu(x[t].reshape(V * Ci) @ Wf + bf)``

with the following BatchNorm's scale and shift absorbed into ``Wf`` and
``bf``, and the data BatchNorm into block 0's. The ``[9, 1]`` temporal
conv stays a convolution with its BatchNorm folded into its kernel and
bias, as does a projecting residual's 1x1 conv. The folded products do
about 8x the multiply-adds of the factored spatial conv (4.14 against 0.50
TFLOP for 64 clips of 300 frames), in dense shapes of ``V * C`` = 75 to
6,400 columns, and every BatchNorm pass of the block is gone.

Three predictors, as in JAX:

* :class:`FusedSTGCNPredictor`: ``Wf`` in ``dtype`` (bfloat16 by default,
  or float32, which follows the TF32 switch as the stock model does);
* :class:`QuantizedSTGCNPredictor` (W8): ``Wf`` stored as int8 with
  per-column scales, dequantized to bfloat16 at the product;
* :class:`Int8STGCNPredictor` (W8A8): the activations quantized per row on
  the fly and the products ``s8 x s8 -> s32`` (``torch._int_mm``).

The fold runs once per predictor on the host, in float64 (numpy), in the
JAX module's order, from the stock model's parameters alone. Any other
model, a trainable adjacency or another block plan raises ``ValueError``:
the JAX functions read the stock parameter names and would fold such a
model as if it were the stock one, dropping what they do not know (ST-PGCN's
projection; a trained adjacency, for the constant graph).

Products with bfloat16 operands accumulate in float32 and return float32,
as JAX's ``preferred_element_type=float32``: on CUDA ``torch.mm(...,
out_dtype=torch.float32)`` and cuDNN's bfloat16 conv read back in float32,
on the CPU the bfloat16-rounded operands multiplied in float32. The JAX
module computes these products with ``einsum``/``dot_general`` outside any
Pallas kernel, and here they are library calls (cuBLAS, cuBLASLt, cuDNN).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch.graphs.ntu_rgb_d import Graph
from skeleton_action_recognition_tpu_torch.models import stgcn
# the stock block plan, which the fold is written for (the JAX predictor's)
from skeleton_action_recognition_tpu_torch.models.stgcn import BLOCK_PLAN
from skeleton_action_recognition_tpu_torch.parallel.sharding import (
    resolve_device,
)

# ``torch._int_mm`` on CUDA takes more than 16 rows and a contraction and
# output width that are multiples of 8; the rows are padded to a multiple
# of 8 as well
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _bn_affine(bn):
    """``BatchNorm`` in eval mode as ``(scale, shift)``, float32 numpy, as
    the JAX ``_bn_affine`` computes them from its float32 leaves."""
    scale = _numpy(bn.weight) / np.sqrt(_numpy(bn.running_var) + bn.epsilon)
    shift = _numpy(bn.bias) - scale * _numpy(bn.running_mean)
    return scale, shift


def block_plan(model) -> tuple:
    """``(filters, stride, residual)`` of each block of ``model``'s
    backbone, as the module tree holds them."""
    backbone = model.backbone
    plan, i = [], 0
    while hasattr(backbone, f"block_{i}"):
        block = getattr(backbone, f"block_{i}")
        conv = block.tgcn.Conv_0
        plan.append((conv.out_channels, conv.stride[0], block.residual))
        i += 1
    return tuple(plan)


def check_foldable(model) -> None:
    """``ValueError`` unless ``model`` is the stock ST-GCN
    (``models.stgcn.Model``, constant adjacency, ``BLOCK_PLAN``), the only
    model whose parameters the fold reads in full."""
    if type(model) is not stgcn.Model:
        raise ValueError(
            "the folded predictors fold the stock ST-GCN "
            f"(models.stgcn.Model) only, not {type(model).__module__}."
            f"{type(model).__name__}: its other parameters would be dropped"
        )
    if getattr(model, "adjacency_matrix", None) is not None:
        raise ValueError(
            "the folded predictors fold the constant spatial adjacency; "
            "a model with trainable_adjacency=True does not fold"
        )
    if (block_plan(model) != BLOCK_PLAN
            or model.backbone.extra_block_name is not None):
        raise ValueError(
            f"the folded predictors fold the block plan {BLOCK_PLAN}, "
            f"not {block_plan(model)}"
        )


def _product(a, w):
    """``a (M, K) @ w (K, N)`` as float32. Float32 operands multiply in
    float32 (TF32 where the switch allows it); bfloat16 ones accumulate in
    float32 and return float32: ``torch.mm``'s ``out_dtype`` on CUDA, the
    rounded operands multiplied in float32 on the CPU, where that overload
    is not registered."""
    if a.dtype == torch.float32:
        return a @ w
    if a.is_cuda:
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


def _conv(z, ck, stride):
    """The SAME ``[9, 1]`` conv of ``z`` rounded to ``ck``'s dtype, read
    back as float32 (no bias): cuDNN in that dtype on CUDA, and on the CPU
    the rounded operands in float32."""
    z = z.to(ck.dtype)
    if ck.dtype != torch.float32 and not z.is_cuda:
        z, ck = z.float(), ck.float()
    return stgcn.same_conv(z, ck, None, stride).float()


def _quantize_cols(w: np.ndarray):
    """Per-output-column symmetric int8 quantization of a 2-D weight, in
    float32 numpy as the JAX ``_quantize_cols``: ``(q int8, scale
    float32)`` with ``q * scale ~= w``."""
    w32 = np.asarray(w, np.float32)
    scale = np.abs(w32).max(axis=0) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w32 / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_rows(x):
    """Dynamic symmetric int8 quantization along the last axis of float32
    ``x``: ``(q, scale)``, ``q`` int8 of ``x``'s shape and ``scale`` of
    ``x.shape[:-1]`` with ``q * scale[..., None] ~= x``; an all-zero row
    gets scale 1. Rounding is half to even, as ``jnp.round``."""
    amax = x.abs().amax(-1)
    scale = torch.where(amax == 0, 1.0, amax / 127.0)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def int8_product(qa, wq):
    """``qa (M, K) @ wq (K', N)`` in int32 through ``torch._int_mm``, with
    ``K' >= K`` a multiple of 8 and ``wq``'s rows past ``K`` zero. ``qa``'s
    columns are padded with zeros to ``K'`` and its rows to a multiple of 8
    and more than 16, the shapes cuBLASLt's int8 GEMM takes on CUDA, where
    ``wq`` must also be column-major (the transpose of a contiguous ``(N,
    K')``: row-major is not supported). Zero padding leaves the integer
    sums exact."""
    m, k = qa.shape
    rows = max(INT_MM_MIN_ROWS, m)
    rows += -rows % INT_MM_MULTIPLE
    if rows != m or wq.shape[0] != k:
        qa = F.pad(qa, (0, wq.shape[0] - k, 0, rows - m))
    return torch._int_mm(qa, wq)[:m]


class FusedSTGCNPredictor:
    """Folded-constant ST-GCN forward for inference.

    Built from the stock ``models.stgcn.Model`` (its parameters and
    BatchNorm statistics; :func:`check_foldable`), its folded weights held
    on ``device`` (the CUDA card unless the caller asks for the CPU):
    ``wf``, ``ck`` and the residual kernel in ``dtype``, the biases and the
    head in float32. Call with ``(N, 3, T, V, M)``; returns float32 logits
    ``(N, num_classes)``.
    """

    def __init__(self, model, dtype=torch.bfloat16, device="cuda"):
        check_foldable(model)
        self.device = resolve_device(device)
        self.dtype = dtype
        backbone = model.backbone
        a = Graph("spatial").A.astype(np.float64)  # (K, V, V)
        k_parts, v = a.shape[0], a.shape[1]
        self.weights = []
        self.static = []

        # data-BN affine over flattened (V*C) features
        dbn_scale, dbn_shift = _bn_affine(backbone.data_bn.BatchNorm_0)

        c_in = stgcn.IN_CHANNELS
        for i, (c_out, stride, residual) in enumerate(BLOCK_PLAN):
            block = getattr(backbone, f"block_{i}")
            dense = block.sgcn.Dense_0  # weight rows k * c_out + o
            kernel = _numpy(dense.weight).astype(np.float64).T.reshape(
                c_in, k_parts, c_out)
            bias = _numpy(dense.bias).astype(np.float64).reshape(
                k_parts, c_out)

            # Wf[(v,ci),(w,co)] = sum_k A[k,v,w] W[ci,k,co], as one BLAS
            # product over k (the JAX module's einsum, whose result is a
            # strided view to copy out, takes about twice as long)
            wf = np.tensordot(a.transpose(1, 2, 0), kernel, axes=([2], [1]))
            wf = np.ascontiguousarray(wf.transpose(0, 2, 1, 3)).reshape(
                v * c_in, v * c_out)
            bf = np.einsum("kvw,ko->wo", a, bias).reshape(v * c_out)

            # fold BN1 (pre-relu) into Wf/bf
            s1, t1 = _bn_affine(block.tgcn.BatchNorm_0)
            wf *= np.tile(s1, v)[None, :]
            bf = bf * np.tile(s1, v) + np.tile(t1, v)

            if i == 0:
                # (x*s + t) @ Wf = x @ (diag(s) Wf) + t @ Wf
                bf = bf + dbn_shift @ wf
                wf *= dbn_scale[:, None]

            # temporal conv (OIHW) with BN2 folded into kernel/bias
            conv = block.tgcn.Conv_0
            ck = _numpy(conv.weight).astype(np.float64)
            cb = _numpy(conv.bias).astype(np.float64)
            s2, t2 = _bn_affine(block.tgcn.BatchNorm_1)
            ck = ck * s2[:, None, None, None]
            cb = cb * s2 + t2

            res = None
            if residual and (c_in != c_out or stride != 1):
                rk = _numpy(block.residual_conv.weight).astype(
                    np.float64)[:, :, 0, 0].T  # (c_in, c_out)
                rb = _numpy(block.residual_conv.bias).astype(np.float64)
                sr, tr = _bn_affine(block.residual_bn)
                res = (self._tensor(rk * sr[None, :], dtype),
                       self._tensor(rb * sr + tr, torch.float32))

            self.weights.append(dict(
                self._spatial_weights(wf),
                bf=self._tensor(bf, torch.float32),
                ck=self._tensor(ck, dtype),
                cb=self._tensor(cb, torch.float32),
                res=res,
            ))
            self.static.append((stride, residual, c_out))
            c_in = c_out

        self.head = (self._tensor(_numpy(backbone.logits.weight),
                                  torch.float32),
                     self._tensor(_numpy(backbone.logits.bias),
                                  torch.float32))

    def _tensor(self, array, dtype):
        """A float64 or float32 numpy array as a ``dtype`` tensor on the
        device, rounded through float32 as JAX's ``jnp.asarray`` rounds
        it."""
        host = torch.from_numpy(np.asarray(array, np.float32))
        return host.to(dtype).to(self.device)

    def _spatial_weights(self, wf):
        """The folded spatial matrix ``wf`` (float64 numpy) as the block's
        device tensors."""
        return {"wf": self._tensor(wf, self.dtype)}

    def _spatial(self, flat, blk):
        """``flat (M, V * C_in) @ Wf`` as float32, without ``bf``."""
        return _product(flat.to(self.dtype), blk["wf"])

    def forward(self, x):
        n, _, t, v, m = x.shape
        h = x.permute(0, 4, 2, 3, 1).reshape(n * m, t, v, -1).float()
        for blk, (stride, residual, c_out) in zip(self.weights, self.static):
            nm, t_cur, _, c_in = h.shape
            z = self._spatial(h.reshape(nm * t_cur, v * c_in), blk)
            z = torch.relu(z + blk["bf"]).reshape(nm, t_cur, v, c_out)
            z = _conv(z, blk["ck"], stride) + blk["cb"]

            if not residual:
                res = 0.0
            elif blk["res"] is None:
                res = h
            else:
                rk, rb = blk["res"]
                strided = h[:, ::stride]
                res = _product(strided.reshape(-1, c_in).to(rk.dtype), rk)
                res = res.reshape(*strided.shape[:3], c_out) + rb
            h = torch.relu(z + res)

        pooled = h.mean(dim=(1, 2))  # (NM, C)
        pooled = pooled.reshape(n, m, -1).mean(dim=1)
        return F.linear(pooled, *self.head)

    def __call__(self, x):
        with torch.inference_mode():
            return self.forward(torch.as_tensor(x, dtype=torch.float32,
                                                device=self.device))


def fused_stgcn_predictor(model, dtype=torch.bfloat16, device="cuda"):
    """The folded predictor of the stock ST-GCN ``model`` in ``dtype``
    on ``device`` (the JAX factory's ``jit`` does not apply: eager; its
    ``mesh`` is ``Predictor(devices=...)``'s replica a device)."""
    return FusedSTGCNPredictor(model, dtype, device)


class QuantizedSTGCNPredictor(FusedSTGCNPredictor):
    """Folded predictor with int8 weight-only storage (W8).

    Each block's folded matrix is held on the device only as int8
    ``wf_q`` with float32 per-column ``wf_scale`` (quantized from its
    bfloat16 rounding, as JAX quantizes its bfloat16 ``wf``), half the
    bytes of bfloat16. At the product ``wf_q`` is cast to bfloat16 and the
    scale applied to the float32 result. The rest of the block is the
    bfloat16 folded predictor's.
    """

    def __init__(self, model, device="cuda"):
        super().__init__(model, dtype=torch.bfloat16, device=device)

    def _spatial_weights(self, wf):
        rounded = torch.from_numpy(np.asarray(wf, np.float32)).to(
            torch.bfloat16).float().numpy()
        q, scale = _quantize_cols(rounded)
        return {"wf_q": self._int8_weight(q),
                "wf_scale": torch.from_numpy(scale).to(self.device)}

    def _int8_weight(self, q):
        """``wf_q`` on the device from the int8 numpy ``q``."""
        return torch.from_numpy(q).to(self.device)

    def _spatial(self, flat, blk):
        wq = blk["wf_q"].to(self.dtype)
        return _product(flat.to(self.dtype), wq) * blk["wf_scale"]


def quantized_stgcn_predictor(model, device="cuda"):
    """The W8 folded predictor of the stock ST-GCN ``model``."""
    return QuantizedSTGCNPredictor(model, device)


class Int8STGCNPredictor(QuantizedSTGCNPredictor):
    """Folded predictor with int8 weights and activations (W8A8).

    Each block's folded product runs as ``s8 x s8 -> s32``
    (:func:`int8_product`, ``torch._int_mm``: cuBLASLt's int8 tensor-core
    GEMM on CUDA), the activations quantized per row on the fly
    (:func:`quantize_rows`) and the int32 sums rescaled by the row scale,
    then by :class:`QuantizedSTGCNPredictor`'s column scales, as JAX does.
    ``wf_q``'s rows are padded with zeros to a multiple of 8 (block 0's 75
    to 80) and it is held column-major, the layouts cuBLASLt's int8 GEMM
    takes. The temporal conv and the residual stay bfloat16.

    The activation rounding adds to the weights' quantization noise:
    validate on a held-out split before serving, as with any post-training
    quantization.
    """

    def _int8_weight(self, q):
        """``q`` with zero rows up to a multiple of 8 (block 0's 75 to 80),
        held column-major, as :func:`int8_product` takes it."""
        q = np.pad(q, ((0, -len(q) % INT_MM_MULTIPLE), (0, 0)))
        return torch.from_numpy(np.ascontiguousarray(q.T)).to(self.device).t()

    def _spatial(self, flat, blk):
        qa, a_scale = quantize_rows(flat)
        acc = int8_product(qa, blk["wf_q"])
        return acc.float() * a_scale[:, None] * blk["wf_scale"]


def int8_stgcn_predictor(model, device="cuda"):
    """The W8A8 folded predictor of the stock ST-GCN ``model``."""
    return Int8STGCNPredictor(model, device)
