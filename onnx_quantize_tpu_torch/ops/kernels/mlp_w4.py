"""Fused W4 GeGLU MLP (decode path): CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/mlp_w4.py``
(``_mlp_call`` -> ``_mlp_kernel``) with ``csrc/mlp_w4.cu``. One launch
computes the whole Gemma MLP over two packed-W4 weights:

    h   = x @ dequant(W_gate_up)          # (M, 2I), float32
    act = gelu_tanh(h[:, :I]) * h[:, I:]  # float32, rounded to x's dtype
    y   = act @ dequant(W_down)           # (M, N), float32

The kernel splits I across blocks and reduces their partial outputs inside
the launch (the source says how). ``mlp_w4_eligible`` is the reference's
predicate, TPU-set limits included (M <= 256 and a 10 MB VMEM estimate), so
the port takes the same sites; ``PERF.md`` lists both limits as open
questions for the H100.

What bounds it on the card: at Gemma-3-270M decode the two packed weights
and their scales are ~2.5 MB a layer, ~0.75 us at 3.35 TB/s; the FMAs on
the CUDA cores and the partials' round trip cost more. ``chip_smoke.py``
times it beside the unfused pair it replaces (W4 gate_up, GeGLU, W4 down);
no single PyTorch call computes the same function.
"""

from __future__ import annotations

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.kernels import (
    check_launch,
    kernel_library,
    pad_to_multiple,
    ptr,
    stream_ptr,
)
from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import (
    expand_w4_scales,
    w4_dequant_matmul_plain,
)

__all__ = ["mlp_w4_eligible", "mlp_w4_fused", "mlp_w4_reference", "mlp_w4", "mlp_w4_plain",
           "mlp_w4_operands"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version.
launches = 0

_TJ = 32  # intermediate columns per block (csrc/mlp_w4.cu)


def mlp_w4_eligible(qt_gu: QTensor, qt_dn: QTensor, M: int) -> bool:
    """Both weights packed-W4 QDQ, lane-tileable, no activation quantization,
    decode-sized M (the reference's predicate)."""
    for qt in (qt_gu, qt_dn):
        if not isinstance(qt, QTensor) or not qt.meta.packed:
            return False
        if qt.meta.fmt != QFormat.QDQ:
            return False
        if qt.meta.input_quant.mode != "none" or qt.meta.output_quant.mode != "none":
            return False
        if qt.meta.shape[1] % 128 != 0:
            return False
        if qt.meta.pack_group % 64 != 0:
            return False
    if qt_gu.meta.shape[1] % 2 != 0 or qt_gu.meta.shape[1] // 2 != qt_dn.meta.shape[0]:
        return False
    inter = qt_gu.meta.shape[1] // 2
    vmem = (
        qt_gu.data.numel() + qt_dn.data.numel()
        + M * 2 * inter * 4
        + M * (2 * qt_dn.data.shape[0]) * 4
        + 2 * max(qt_gu.meta.pack_group * qt_gu.meta.shape[1],
                  qt_dn.meta.pack_group * qt_dn.meta.shape[1]) * 4
    )
    return M <= 256 and vmem <= 10 * 1024 * 1024


def mlp_w4_plain(x2d: torch.Tensor, wg: torch.Tensor, sg: torch.Tensor, zg: torch.Tensor,
                 wd: torch.Tensor, sd: torch.Tensor, zd: torch.Tensor, *, gs_g: int, gs_d: int,
                 signed_g: bool, signed_d: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands: the
    unfused chain of the W4 kernel's plain version. x2d (M, K_pad); returns
    (M, N) float32."""
    h = w4_dequant_matmul_plain(x2d, wg, sg, zg, gs=gs_g, signed=signed_g)
    inter = h.shape[1] // 2
    act = torch.nn.functional.gelu(h[:, :inter], approximate="tanh") * h[:, inter:]
    act = pad_to_multiple(act.to(x2d.dtype), 1, 2 * wd.shape[0]).contiguous()
    return w4_dequant_matmul_plain(act, wd, sd, zd, gs=gs_d, signed=signed_d)


def _check_operands(x2d, wg, sg, zg, wd, sd, zd, gs_g, gs_d):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mlp_w4: x must be float32 or bfloat16, got {x2d.dtype}")
    if wg.dtype != torch.uint8 or wd.dtype != torch.uint8:
        raise TypeError("mlp_w4: packed weights must be uint8")
    M, K_pad = x2d.shape
    half_g, n2 = wg.shape
    half_d, N = wd.shape
    inter = n2 // 2
    if gs_g <= 0 or half_g % gs_g or K_pad != 2 * half_g or n2 % (2 * _TJ):
        raise ValueError(f"mlp_w4: x {tuple(x2d.shape)} does not match gate-up data "
                         f"{tuple(wg.shape)} with group size {gs_g}")
    if gs_d <= 0 or gs_d % _TJ or half_d % gs_d or 2 * half_d < inter:
        raise ValueError(f"mlp_w4: down data {tuple(wd.shape)} does not take {inter} "
                         f"intermediate rows with group size {gs_d}")
    for s, z, shape in ((sg, zg, (half_g // gs_g, 2, n2)), (sd, zd, (half_d // gs_d, 2, N))):
        if s.dtype != torch.float32 or z.dtype != torch.float32 or tuple(s.shape) != shape \
                or z.shape != s.shape:
            raise ValueError(f"mlp_w4: scales/zps must be float32 {shape}")
    for t in (x2d, wg, sg, zg, wd, sd, zd):
        if t.device != x2d.device:
            raise ValueError("mlp_w4: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("mlp_w4: operands must be contiguous")


def mlp_w4(x2d: torch.Tensor, wg: torch.Tensor, sg: torch.Tensor, zg: torch.Tensor,
           wd: torch.Tensor, sd: torch.Tensor, zd: torch.Tensor, *, gs_g: int, gs_d: int,
           signed_g: bool, signed_d: bool) -> torch.Tensor:
    """Launch the fused MLP kernel on CUDA tensors; CPU tensors get the plain
    version. Operands as :func:`mlp_w4_plain`; returns (M, N) float32."""
    _check_operands(x2d, wg, sg, zg, wd, sd, zd, gs_g, gs_d)
    kw = dict(gs_g=gs_g, gs_d=gs_d, signed_g=signed_g, signed_d=signed_d)
    if x2d.device.type == "cpu":
        return mlp_w4_plain(x2d, wg, sg, zg, wd, sd, zd, **kw)
    if x2d.device.type != "cuda":
        raise ValueError(f"mlp_w4: unsupported device {x2d.device}")
    M, K_pad = x2d.shape
    inter = wg.shape[1] // 2
    N = wd.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x2d.device)
    if M == 0 or N == 0:
        return out
    # The blocks' partial outputs, and the grid barrier's counter.
    ws = torch.empty((inter // _TJ, M, N), dtype=torch.float32, device=x2d.device)
    counter = torch.empty((1,), dtype=torch.int32, device=x2d.device)
    err = kernel_library().oqt_mlp_w4(
        ptr(x2d), int(x2d.dtype == torch.bfloat16), ptr(wg), ptr(sg), ptr(zg), ptr(wd), ptr(sd),
        ptr(zd), ptr(ws), ptr(counter), ptr(out), M, K_pad, inter, N, gs_g, gs_d,
        int(signed_g), int(signed_d), stream_ptr(x2d.device),
    )
    check_launch(err, "oqt_mlp_w4")
    global launches
    launches += 1
    return out


def mlp_w4_operands(x: torch.Tensor, qt_gu: QTensor, qt_dn: QTensor) -> tuple[tuple, dict]:
    """The operands and keyword arguments that :func:`mlp_w4` and its plain
    version take for the MLP of ``x`` (..., K)."""
    K = qt_gu.meta.shape[0]
    # Zero x columns meet the zero pad rows of the packed gate-up weight.
    x2d = pad_to_multiple(x.reshape(-1, K), 1, 2 * qt_gu.data.shape[0]).contiguous()
    sg, zg = expand_w4_scales(qt_gu)
    sd, zd = expand_w4_scales(qt_dn)
    return ((x2d, qt_gu.data, sg, zg, qt_dn.data, sd, zd),
            dict(gs_g=qt_gu.meta.pack_group, gs_d=qt_dn.meta.pack_group,
                 signed_g=qt_gu.meta.qt.is_signed, signed_d=qt_dn.meta.qt.is_signed))


def mlp_w4_fused(x: torch.Tensor, qt_gu: QTensor, qt_dn: QTensor) -> torch.Tensor:
    """GeGLU MLP over two packed-W4 weights in one kernel. x: (..., K) ->
    (..., N) float32."""
    operands, kw = mlp_w4_operands(x, qt_gu, qt_dn)
    return mlp_w4(*operands, **kw).reshape(*x.shape[:-1], qt_dn.meta.shape[1])


def mlp_w4_reference(x: torch.Tensor, qt_gu: QTensor, qt_dn: QTensor) -> torch.Tensor:
    """The reference's oracle: the unfused computation through the plain QDQ
    reference (dots in x's dtype)."""
    from onnx_quantize_tpu_torch.ops.reference import _qdq_matmul

    h = _qdq_matmul(x, qt_gu)
    inter = h.shape[-1] // 2
    act = torch.nn.functional.gelu(h[..., :inter], approximate="tanh") * h[..., inter:]
    return _qdq_matmul(act.to(x.dtype), qt_dn)
