"""Fused temporal chain of an ST-GCN block: the CUDA kernels and their plain
versions.

Counterpart of ``skeleton_action_recognition_tpu/ops/pallas/tconv.py``'s
``affine_relu_tconv`` and its VJP. The kernel in ``csrc/tconv_fwd.cu``
replaces the TPU kernel ``_fwd_kernel``: for ``s (NM, T, V, C)``,

    ``h = relu(s * scale + shift)``        (BN1's normalize, folded)
    ``u = conv9x1(h) + bias``              (SAME over T, stride 1)
    ``sum_u, sumsq_u``                     (BN2's batch statistics)

in one pass, and ``csrc/tconv_bwd.cu`` replaces ``_bwd_kernel``: from the
effective cotangent ``gue`` of ``u``, the gradients of ``s``, ``scale``,
``shift``, the conv weight and its bias. The SAME padding is on ``h``, not
on ``s``: the padded frames are zero after the affine and the ReLU.

Rounding follows the TPU kernels: ``h``, the weight and ``gue`` in the
matmul type (``s``'s dtype), every product summed in f32, ``u`` and
``g_s`` stored in ``s``'s dtype, the statistics taken on ``u`` as stored,
the ReLU mask and ``dscale = sum(ghm * s)`` in f32.

The conv weight is ``nn.Conv2d``'s ``(C, C, 9, 1)``, so a module holding it
keeps the stock ``TemporalConv``'s state dict.

The block's tail after the chain, BN2's normalize, the residual add and the
ReLU (:func:`block_tail`), and the backward's fold of the statistics'
cotangents into ``gue`` (:func:`tconv_gue`) run through ``csrc/
block_tail.cu``, which replaces no TPU kernel: XLA fuses that elementwise
tail into one pass on the TPU, and eager PyTorch ran it as ~18 passes a
block. Device-memory bytes bound them; each equals its eager expression bit
for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from skeleton_action_recognition_tpu_torch.ops.build import (
    check_cuda,
    kernel_function,
    launch,
)

TAPS = 9
HALO = TAPS // 2
NUM_JOINTS = 25
# the tiles of the forward and input-gradient kernels, one statistics
# partial per tile and channel: csrc/tconv_tile.cuh's 16 frames of 24
# (clip, joint) sequences (f32), csrc/tconv_mma.cuh's 512 rows of a clip
# (bf16)
_TILE_FRAMES, _TILE_SLOTS, _MMA_TILE_ROWS = 16, 24, 512
# the dW kernels' tiling and the blocks to aim for: csrc/tconv_bwd.cu's
# output and input channels per block and two waves of three blocks per SM
# of the H100's 132 (f32; two waves ran ~1% faster than one);
# csrc/tconv_mma.cuh's output and input channels per block and one wave of
# one block per SM (bf16). The split count depends on the shapes alone,
# which keeps the sums' order fixed.
_DW_OT, _DW_IT, _DW_TARGET_BLOCKS = 32, 32, 2 * 3 * 132
_MMA_DW_OT, _MMA_DW_IT, _MMA_DW_TARGET_BLOCKS = 64, 64, 132


def _acc_dtype(dtype):
    """The type sums are taken in: f32, or f64 for f64 inputs (the
    gradient checks of the plain versions)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def affine_relu_tconv_reference(s, scale, shift, weight, bias):
    """Plain PyTorch version of the forward kernel.

    ``s (NM, T, V, C)`` f32 or bf16 (or f64); ``scale``, ``shift``,
    ``bias (C,)`` and ``weight (C, C, 9, 1)`` in f32 (f64) ->
    ``(u, sum_u, sumsq_u)``: ``u`` in ``s.dtype``, the per-channel sums
    of ``u`` and ``u**2`` over all ``(NM, T, V)`` rows in f32, taken on
    ``u`` as stored.
    """
    acc = _acc_dtype(s.dtype)
    h = torch.relu(s.to(acc) * scale + shift).to(s.dtype).to(acc)
    y = F.conv2d(_nchw(h), weight.to(s.dtype).to(acc),
                 padding=(HALO, 0))
    u = (_nhwc(y) + bias).to(s.dtype)
    uf = u.to(acc)
    return u, uf.sum((0, 1, 2)), (uf * uf).sum((0, 1, 2))


def affine_relu_tconv_backward_reference(s, scale, shift, weight, gue):
    """Plain PyTorch version of the backward kernel.

    ``gue (NM, T, V, C)``, the cotangent of ``u`` with the statistics'
    cotangents folded in, in ``s.dtype``. Returns ``(g_s, dscale, dshift,
    dweight, dbias)``: ``g_s`` in ``s.dtype``, the rest in f32 (f64),
    ``dweight`` as ``(C, C, 9, 1)``.
    """
    acc = _acc_dtype(s.dtype)
    sf = s.to(acc)
    pre = sf * scale + shift
    g = gue.to(s.dtype).to(acc)
    w = weight.to(s.dtype).to(acc)
    # the conv's input gradient: the taps reversed and transposed
    gh = _nhwc(F.conv2d(_nchw(g), w.transpose(0, 1).flip(2),
                        padding=(HALO, 0)))
    ghm = torch.where(pre > 0, gh, torch.zeros_like(gh))
    g_s = (ghm * scale).to(s.dtype)
    dscale = (ghm * sf).sum((0, 1, 2))
    dshift = ghm.sum((0, 1, 2))
    # dW[:, :, dt] = sum over rows of gue (x) h shifted by dt - 4 frames
    h = torch.relu(pre).to(s.dtype).to(acc)
    hp = F.pad(h, (0, 0, 0, 0, HALO, HALO))
    c = s.shape[-1]
    g2 = g.reshape(-1, c)
    dweight = torch.stack(
        [g2.T @ hp[:, dt:dt + s.shape[1]].reshape(-1, c)
         for dt in range(TAPS)], dim=-1,
    )[..., None]
    return g_s, dscale, dshift, dweight, g.sum((0, 1, 2))


def weight_operands(weight, dtype):
    """The conv weight as the kernels read it, ``(w_fwd, w_dgrad)``,
    permuted once a call as the JAX wrapper does its ``wall`` and ``wt``
    (``ops/pallas/tconv.py:322-325, 388-391``).

    f32: each ``(C, 9, C)`` f32, ``w_fwd[ci, dt, co] = weight[co, ci, dt]``
    (``wall``) and ``w_dgrad[co, dt, ci] = weight[co, ci, 8 - dt]`` (``wt``:
    the taps reversed and transposed), permuted only. bf16: each ``(9, C,
    C)`` cast to bf16, ``w_fwd[dt, co, ci] = weight[co, ci, dt]`` (the
    forward's B as [n][k]) and ``w_dgrad[dt, ci, co] = weight[co, ci, 8 -
    dt]``."""
    w = weight[..., 0].to(dtype)  # (co, ci, dt)
    if dtype == torch.bfloat16:
        return (w.permute(2, 0, 1).contiguous(),
                w.flip(2).permute(2, 1, 0).contiguous())
    return (w.permute(1, 2, 0).contiguous(),
            w.flip(2).permute(0, 2, 1).contiguous())


def _check(s, scale, shift, weight, bias=None):
    """Raise on what the kernels do not take (``bias=None``: the
    backward's arguments)."""
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"s must be float32 or bfloat16, got {s.dtype}")
    if s.ndim != 4 or s.shape[2] != NUM_JOINTS:
        raise ValueError(
            f"s must be (NM, T, {NUM_JOINTS}, C), got {tuple(s.shape)}"
        )
    c = s.shape[3]
    expected = {
        "scale": (scale, (c,)),
        "shift": (shift, (c,)),
        "weight": (weight, (c, c, TAPS, 1)),
        "bias": (bias, (c,)),
    }
    if bias is None:
        del expected["bias"]
    for name, (t, shape) in expected.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be float32 {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != s.device:
            raise ValueError(f"{name} is on {t.device}, s on {s.device}")


def _check_kernel(s):
    """What only the CUDA kernels ask: the bf16 ones load channels in
    pairs."""
    if s.dtype == torch.bfloat16 and s.shape[-1] % 2:
        raise ValueError(
            f"the bf16 kernels take an even C, got {s.shape[-1]}"
        )


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def _kernel(source: str, n_pointers: int, n_ints: int, dtype):
    stem = source.removesuffix(".cu")
    return kernel_function(source, f"{stem}_{_suffix(dtype)}", n_pointers,
                           n_ints)


def _tile_partials(nm, t, c, dtype):
    """Partials of the tile kernels' two channel sums: one per (tile,
    channel)."""
    if dtype == torch.bfloat16:
        return nm * -(-(t * NUM_JOINTS) // _MMA_TILE_ROWS) * 2 * c
    return (-(-(nm * NUM_JOINTS) // _TILE_SLOTS) * -(-t // _TILE_FRAMES)
            * 2 * c)


def _forward(s, scale, shift, weight, bias):
    """``(u, sum_u, sumsq_u)`` through the kernel on CUDA, the plain
    version on the CPU."""
    if s.device.type == "cpu":
        return affine_relu_tconv_reference(s, scale, shift, weight, bias)
    check_cuda("tconv", s=s, scale=scale, shift=shift, weight=weight,
               bias=bias)
    _check_kernel(s)
    nm, t, _, c = s.shape
    u = torch.empty_like(s)
    sums = torch.zeros(2 * c, dtype=torch.float32, device=s.device)
    if u.numel() == 0:
        return u, sums[:c], sums[c:]
    ws = torch.empty(_tile_partials(nm, t, c, s.dtype), dtype=torch.float32,
                     device=s.device)
    w = weight_operands(weight, s.dtype)[0]
    launch(
        _kernel("tconv_fwd.cu", 8, 3, s.dtype), "tconv_fwd", s.device,
        s.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        bias.data_ptr(), u.data_ptr(), ws.data_ptr(), sums.data_ptr(),
        nm, t, c,
    )
    return u, sums[:c], sums[c:]


def backward_splits(nm: int, t: int, c: int, dtype) -> int:
    """How many splits the dW kernels sum ``dW``/``dbias`` over: as many as
    two waves of their blocks hold in f32 (three blocks per SM), one wave
    in bf16 (one), at least one (clip, joint) sequence (f32) or one clip
    (bf16) each. The workspace holds one ``9 * C * C + C`` f32 partial per
    split: at most ~30 MB at the model's shapes."""
    del t  # the splits cut whole sequences, of any length
    if dtype == torch.bfloat16:
        tiles = -(-c // _MMA_DW_OT) * -(-c // _MMA_DW_IT)
        return max(1, min(_MMA_DW_TARGET_BLOCKS // tiles, nm))
    tiles = -(-c // _DW_OT) * -(-c // _DW_IT)
    return max(1, min(_DW_TARGET_BLOCKS // tiles, nm * NUM_JOINTS))


def affine_relu_tconv_backward(s, scale, shift, weight, gue):
    """Backward of :func:`affine_relu_tconv` through the CUDA kernels.

    Arguments as :func:`affine_relu_tconv_backward_reference`, whose
    results it returns. A CPU tensor goes to that plain version; a CUDA
    tensor launches the kernels (counted in
    ``launch.tconv_bwd``) or raises.
    """
    _check(s, scale, shift, weight)
    if tuple(gue.shape) != tuple(s.shape) or gue.device != s.device:
        raise ValueError(
            f"gue must be {tuple(s.shape)} on {s.device}, got "
            f"{tuple(gue.shape)} on {gue.device}"
        )
    return _backward(s, scale, shift, weight, gue)


def _backward(s, scale, shift, weight, gue):
    """The gradients through the kernels on CUDA, the plain version on
    the CPU."""
    if s.device.type == "cpu":
        return affine_relu_tconv_backward_reference(
            s, scale, shift, weight, gue
        )
    gue = gue.to(s.dtype)
    check_cuda("tconv", s=s, gue=gue, scale=scale, shift=shift,
               weight=weight)
    _check_kernel(s)
    nm, t, _, c = s.shape
    g_s = torch.empty_like(s)
    sums = torch.zeros(2 * c, dtype=torch.float32, device=s.device)
    dwb = torch.zeros(TAPS * c * c + c, dtype=torch.float32,
                      device=s.device)
    if nm * t:
        splits = backward_splits(nm, t, c, s.dtype)
        ws_tile = torch.empty(_tile_partials(nm, t, c, s.dtype),
                              dtype=torch.float32, device=s.device)
        ws_w = torch.empty(splits * (TAPS * c * c + c),
                           dtype=torch.float32, device=s.device)
        w = weight_operands(weight, s.dtype)[1]
        launch(
            _kernel("tconv_bwd.cu", 10, 4, s.dtype), "tconv_bwd", s.device,
            s.data_ptr(), gue.data_ptr(), w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), g_s.data_ptr(),
            ws_tile.data_ptr(), ws_w.data_ptr(), sums.data_ptr(),
            dwb.data_ptr(), nm, t, c, splits,
        )
    dweight = dwb[:TAPS * c * c].view(c, c, TAPS, 1)
    return g_s, sums[:c], sums[c:], dweight, dwb[TAPS * c * c:]


class AffineReluTconv(torch.autograd.Function):
    """The fused temporal chain with the kernels on both passes. Saves
    ``s``, ``scale``, ``shift``, ``weight``, ``bias`` and ``u``, as the JAX
    VJP does (``ops/pallas/tconv.py:362-364``); its backward folds the
    statistics' cotangents into ``gue = g_u + g_sum + 2 u g_sumsq`` in f32
    and casts it to the matmul type (``:380-386``)."""

    @staticmethod
    def forward(ctx, s, scale, shift, weight, bias):
        u, sum_u, sumsq_u = _forward(s, scale, shift, weight, bias)
        ctx.save_for_backward(s, scale, shift, weight, bias, u)
        return u, sum_u, sumsq_u

    @staticmethod
    def backward(ctx, g_u, g_sum, g_sumsq):
        s, scale, shift, weight, _, u = ctx.saved_tensors
        return _backward(s, scale, shift, weight,
                         tconv_gue(g_u, u, g_sum, g_sumsq))


def affine_relu_tconv(s, scale, shift, weight, bias):
    """``u = conv9x1(relu(s * scale + shift)) + bias`` with the per-channel
    sums of ``u`` and ``u**2``, differentiable in every argument.

    Same arguments and results as :func:`affine_relu_tconv_reference`, with
    ``s`` in f32 or bf16. CPU tensors go to the plain versions; CUDA
    tensors launch the forward kernel (counted in
    ``launch.tconv_fwd``) and, in the backward, the backward
    kernels, or raise.
    """
    _check(s, scale, shift, weight, bias)
    return AffineReluTconv.apply(s, scale, shift, weight, bias)


# csrc/block_tail.cuh's threads a block and most blocks a launch: the tail's
# backward writes one partial of 2 C sums a block
_TAIL_THREADS, _TAIL_BLOCKS = 256, 4 * 132


def tconv_gue_reference(g_u, u, g_sum, g_sumsq):
    """Plain PyTorch version of the fold kernel: the cotangent of ``u``
    with the statistics' cotangents folded in, ``gue = g_u + g_sum + 2 u
    g_sumsq`` in f32 (f64) and rounded to ``u.dtype``, as the JAX VJP does
    (``ops/pallas/tconv.py:380-386``)."""
    acc = _acc_dtype(u.dtype)
    return (g_u.to(acc) + g_sum + 2.0 * u.to(acc) * g_sumsq).to(u.dtype)


def tconv_gue(g_u, u, g_sum, g_sumsq):
    """:func:`tconv_gue_reference`'s ``gue``, through ``csrc/
    block_tail.cu``'s fold kernel (counted in ``launch.tconv_gue``) for
    CUDA tensors, bit for bit."""
    if u.device.type == "cpu":
        return tconv_gue_reference(g_u, u, g_sum, g_sumsq)
    g_u, g_sum, g_sumsq = (g_u.to(u.dtype).contiguous(), g_sum.contiguous(),
                           g_sumsq.contiguous())
    check_cuda("tconv_gue", g_u=g_u, u=u, g_sum=g_sum, g_sumsq=g_sumsq)
    gue = torch.empty_like(u)
    c = u.shape[-1]
    if gue.numel():
        launch(_tail_kernel("tconv_gue", 5, u.dtype), "tconv_gue", u.device,
               g_u.data_ptr(), u.data_ptr(), g_sum.data_ptr(),
               g_sumsq.data_ptr(), gue.data_ptr(), u.numel() // c, c,
               _tail_vec(c, g_u=g_u, u=u))
    return gue


def block_tail_reference(u, scale2, shift2, res=None):
    """Plain PyTorch version of the tail's forward kernel: the block's
    output ``relu(u * scale2 + shift2 + res)`` (``res=None``: no
    residual), computed in f32 (f64 for an f64 ``u``) as the eager block
    did, and left in f32."""
    y = u.to(_acc_dtype(u.dtype)) * scale2 + shift2
    return torch.relu(y if res is None else y + res)


def block_tail_backward_reference(g_out, out, u, scale2, res_dtype=None):
    """Plain PyTorch version of the tail's backward kernel: from the
    cotangent ``g_out`` of ``out = block_tail_reference(u, scale2, shift2,
    res)``, ``(g_u, g_scale2, g_shift2, g_res)``. The ReLU's mask is
    ``out > 0`` (autograd's ``threshold_backward`` on the saved output);
    ``g_u`` in ``u.dtype``; the two sums over every row in f32 (f64);
    ``g_res`` in ``res_dtype``, None for None."""
    acc = _acc_dtype(u.dtype)
    gm = torch.where(out <= 0, torch.zeros_like(g_out), g_out)
    rows = tuple(range(u.ndim - 1))
    return ((gm * scale2).to(u.dtype), (gm * u.to(acc)).sum(rows),
            gm.sum(rows), None if res_dtype is None else gm.to(res_dtype))


def _tail_kernel(name: str, n_pointers: int, *dtypes):
    return kernel_function("block_tail.cu",
                           "_".join([name, *map(_suffix, dtypes)]),
                           n_pointers, 3)


def _tail_vec(c: int, **tensors) -> int:
    """The channels a thread of the tail kernels takes at once: the largest
    of 8, 4, 2 and 1 that divides ``c`` and leaves at most a block's
    threads to a row. Raises unless each of ``tensors`` starts on a
    16-byte boundary, as every fresh allocation does: the kernels' vector
    accesses need it."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for vec in (8, 4, 2, 1):
        if c % vec == 0 and c // vec <= _TAIL_THREADS:
            return vec
    raise ValueError(
        f"the block-tail kernels take C <= {_TAIL_THREADS} or a multiple of "
        f"2, 4 or 8 up to {8 * _TAIL_THREADS}, got {c}"
    )


def _tail_forward(u, scale2, shift2, res):
    """The block's output through the kernel on CUDA, the plain version on
    the CPU."""
    if u.device.type == "cpu":
        return block_tail_reference(u, scale2, shift2, res)
    check_cuda("block_tail", u=u, scale2=scale2, shift2=shift2,
               **({} if res is None else {"res": res}))
    out = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    c = u.shape[-1]
    if out.numel():
        vec = _tail_vec(c, u=u, **({} if res is None else {"res": res}))
        launch(
            _tail_kernel("block_tail_fwd", 5, u.dtype,
                         torch.float32 if res is None else res.dtype),
            "block_tail_fwd", u.device, u.data_ptr(), scale2.data_ptr(),
            shift2.data_ptr(), None if res is None else res.data_ptr(),
            out.data_ptr(), u.numel() // c, c, vec,
        )
    return out


def _tail_backward(g_out, out, u, scale2, res_dtype):
    """``(g_u, g_scale2, g_shift2, g_res)`` through the kernel on CUDA, the
    plain version on the CPU."""
    if u.device.type == "cpu":
        return block_tail_backward_reference(g_out, out, u, scale2,
                                             res_dtype)
    check_cuda("block_tail", g_out=g_out, out=out, u=u, scale2=scale2)
    c = u.shape[-1]
    g_u = torch.empty_like(u)
    g_res = (None if res_dtype is None
             else torch.empty(u.shape, dtype=res_dtype, device=u.device))
    sums = torch.zeros(2 * c, dtype=torch.float32, device=u.device)
    if u.numel():
        rows = u.numel() // c
        vec = _tail_vec(c, g_out=g_out, out=out, u=u)
        slots = _TAIL_THREADS // (c // vec)
        parts = min(-(-rows // slots), _TAIL_BLOCKS)
        ws = torch.empty(parts * 2 * c, dtype=torch.float32,
                         device=u.device)
        launch(
            _tail_kernel("block_tail_bwd", 8, u.dtype, res_dtype or
                         torch.float32),
            "block_tail_bwd", u.device, g_out.data_ptr(), out.data_ptr(),
            u.data_ptr(), scale2.data_ptr(), g_u.data_ptr(),
            None if g_res is None else g_res.data_ptr(), ws.data_ptr(),
            sums.data_ptr(), rows, c, vec,
        )
    return g_u, sums[c:], sums[:c], g_res


class BlockTail(torch.autograd.Function):
    """The block's tail with the kernels on both passes. Saves ``u`` (the
    tensor :class:`AffineReluTconv` saves too), ``scale2`` and ``out`` (what
    the eager ReLU saved), and no f32 copy of ``u``."""

    @staticmethod
    def forward(ctx, u, scale2, shift2, res):
        out = _tail_forward(u, scale2, shift2, res)
        ctx.res_dtype = None if res is None else res.dtype
        ctx.save_for_backward(u, scale2, out)
        return out

    @staticmethod
    def backward(ctx, g_out):
        u, scale2, out = ctx.saved_tensors
        res_dtype = ctx.res_dtype if ctx.needs_input_grad[3] else None
        return _tail_backward(g_out.contiguous(), out, u, scale2, res_dtype)


def block_tail(u, scale2, shift2, res=None):
    """The output of a fused ST-GCN block, ``relu(u * scale2 + shift2 +
    res)`` in f32, differentiable in every argument: BN2's normalize
    (folded into ``scale2``, ``shift2`` from the batch's statistics), the
    residual add and the ReLU after the fused temporal chain.

    ``u (..., C)`` in f32 or bf16 (the chain's output); ``scale2``,
    ``shift2`` f32 ``(C,)``; ``res`` like ``u`` in shape, f32 or bf16, or
    None. CPU tensors go to the plain versions; CUDA tensors launch the
    forward kernel (counted in ``launch.block_tail_fwd``) and, in the
    backward, its backward kernel (``launch.block_tail_bwd``), or raise.
    """
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    c = u.shape[-1]
    for name, t in (("scale2", scale2), ("shift2", shift2)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be float32 ({c},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if res is not None and (res.dtype not in (torch.float32, torch.bfloat16)
                            or res.shape != u.shape):
        raise ValueError(f"res must be float32 or bfloat16 "
                         f"{tuple(u.shape)}, got {res.dtype} "
                         f"{tuple(res.shape)}")
    for t in (scale2, shift2) + (() if res is None else (res,)):
        if t.device != u.device:
            raise ValueError(f"an argument is on {t.device}, u on {u.device}")
    return BlockTail.apply(u, scale2, shift2, res)
