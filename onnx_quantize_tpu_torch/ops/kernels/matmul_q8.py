"""Q8 (full-integer QLINEAR matmul): CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/matmul_q8.py``
(``_q8_call`` -> ``_q8_kernel``) with ``csrc/matmul_q8.cu``. One launch runs
a whole QLINEAR site: the static input quantization (x cast to float32
first, as the reference's type promotion does), the int8 x int8 dot in
int32, the exact zero-point corrections and int32 bias, the requantization
by ``x_scale * w_scale / y_scale``, and the dequantization of the output
codes. The result equals ``ops.reference._qlinear_matmul`` bit for bit.

The per-site constants (column sums of the int8-shifted weights, shifted
zero points, the requant factor per column, and the activation qparams as
device tensors) are computed once and cached on the QTensor, as the engine
bakes the W4 scales once; a changed QTensor (``dataclasses.replace``,
``.to``) is a new object and computes them anew.

What bounds it on the card: bytes. A Gemma-3-270M layer's seven sites read
5.57 MB of int8 weights at decode (M = 32, ~1.7 us at 3.35 TB/s) and write
113 MB of float32 outputs at a 32x128 prefill (M = 4096, ~51 us with the
bf16 x). The dot runs on the tensor cores (``mma.sync`` m16n8k32 s8), x is
quantized while it is staged, and at decode K is split until the grid fills
the SMs, the int32 partials summed inside the same launch. A weight N that
is not a multiple of 16 (or a weight pointer off a 16-byte boundary) keeps
the ``__dp4a`` kernel of the first port. :func:`q8_plan` chooses the route,
the tile and the split; the source note in ``csrc/matmul_q8.cu`` gives the
design and why the bits hold. ``PERF.md`` holds its times beside the plain
version's and ``torch._int_mm``'s on the int32 core (a yardstick the port
never calls).

The predicate is the reference's without its TPU lane rule ``N % 128 == 0``:
every QLINEAR site with both activation scales calibrated takes the kernel,
which masks a ragged N (the reference runs other N through its jnp oracle).
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat
from onnx_quantize_tpu_torch.nn.qtensor import QBias, QTensor
from onnx_quantize_tpu_torch.ops.kernels import (
    check_launch,
    four_columns_fill,
    kernel_library,
    ptr,
    register_kernel,
    split_scratch,
    stream_ptr,
)

__all__ = ["Q8Constants", "Q8Plan", "q8_plan", "q8_matmul", "q8_matmul_plain", "q8_constants",
           "q8_operands", "q8_qlinear_matmul"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version.
launches = 0

# Rows of K per float32 partial product in the plain version: shifted codes
# are at most 128 in magnitude, so every partial sum stays below
# 128 * 128 * 256 = 2^22 < 2^24 and each chunk's dot is exact.
_EXACT_ROWS = 256

# K rows an s8 mma slice covers (m16n8k32): the K split's granularity.
MMA_K = 32
# Bytes of one cp.async copy: the mma route stages weight rows in such chunks,
# so it needs N % 16 == 0 and a 16-byte-aligned weight pointer.
CP_ASYNC_BYTES = 16
# The int32 dot is exact while 128 * 128 * K < 2^31 (shifted codes).
MAX_K = 1 << 17


@dataclasses.dataclass(frozen=True)
class Q8Plan:
    """How one Q8 call launches: ``route`` "mma" (s8 tensor cores) or "simt"
    (``__dp4a`` on the CUDA cores); a block covers ``bm`` rows of M and ``bn``
    columns; ``splits`` blocks share each (bm, bn) tile along K, each walking
    ``split_slices`` slices of 32 rows (mma route; 0 for simt); ``blocks``
    in all."""

    route: str
    bm: int
    bn: int
    splits: int
    split_slices: int
    blocks: int

    @property
    def tiles(self) -> int:
        return self.blocks // self.splits


def _tiles(M: int, N: int, bm: int, bn: int) -> int:
    return -(-M // bm) * -(-N // bn)


def q8_plan(M: int, K: int, N: int, sms: int) -> Q8Plan:
    """The launch plan of ``csrc/matmul_q8.cu`` for x (M, K) against (K, N)
    int8/uint8 weights on a card of ``sms`` SMs.

    N % 16 == 0 (weight rows move in 16-byte ``cp.async`` chunks) takes the
    mma route. Up to M = 64: 32-row tiles of 64 columns, or of 32 where 64
    could not give every SM a block even split to single slices (the
    Gemma-3-270M k and v sites). Above: 128 x 128 tiles, or 64 x 128 where
    128-row tiles number fewer than the SMs. While fewer than half the SMs
    have a tile, K is split into ranges of whole 32-row slices, as many as
    fill the SMs (every 270M site at M = 32 launches 160 blocks; none splits
    at M = 4096). Anything else takes the simt route.
    """
    if N % CP_ASYNC_BYTES:
        return _simt_plan(M, N, sms)
    slices = -(-K // MMA_K)
    if M <= 64:
        bm = 32
        bn = 64 if _tiles(M, N, bm, 64) * slices >= sms else 32
    else:
        bn = 128
        bm = 128 if _tiles(M, N, 128, bn) >= sms else 64
    tiles = _tiles(M, N, bm, bn)
    per = slices
    if 2 * tiles <= sms:
        per = max(1, slices // -(-sms // tiles))
    splits = -(-slices // per)
    return Q8Plan("mma", bm, bn, splits, per, tiles * splits)


def _simt_plan(M: int, N: int, sms: int) -> Q8Plan:
    """32- or 64-row tiles; four columns a thread only when N % 4 == 0 and the
    wide blocks still fill every SM."""
    bm = 32 if M <= 32 else 64
    bn = 128 if four_columns_fill(N, sms) else 32
    return Q8Plan("simt", bm, bn, 1, 0, _tiles(M, N, bm, bn))


@dataclasses.dataclass(frozen=True)
class Q8Constants:
    """A QLINEAR site's constants in the kernel's layout, on its device."""

    wsum: torch.Tensor  # (N,) int32: column sums of the int8-shifted weights
    wzp: torch.Tensor  # (N,) int32: weight zero points, shifted with the codes
    req: torch.Tensor  # (N,) float32: x_scale * w_scale / y_scale
    fparams: torch.Tensor  # (2,) float32: x_scale, y_scale
    iparams: torch.Tensor  # (2,) int32: x_zp, y_zp (unshifted)
    x_shift: int  # 128 for uint8 input codes, 0 for int8
    iq: tuple[int, int]  # input code range
    oq: tuple[int, int]  # output code range


def q8_constants(qt: QTensor) -> Q8Constants:
    """The site's constants, computed once and cached on ``qt``."""
    cached = qt.__dict__.get("_q8_constants")
    if cached is not None:
        return cached
    meta = qt.meta
    K, N = meta.shape
    in_spec, out_spec = meta.input_quant, meta.output_quant
    w_shift = 0 if meta.qt.is_signed else 128
    w8 = qt.data.to(torch.int32) - w_shift
    x_scale = qt.input_scale.to(torch.float32)
    y_scale = qt.output_scale.to(torch.float32)
    req = x_scale * qt.scale.to(torch.float32) / y_scale
    consts = Q8Constants(
        wsum=w8.sum(dim=0, dtype=torch.int32).contiguous(),
        wzp=(qt.zero_point.to(torch.int32) - w_shift).expand(N).contiguous(),
        req=req.expand(N).contiguous(),
        fparams=torch.stack([x_scale, y_scale]).reshape(2),
        iparams=torch.stack([qt.input_zero_point.to(torch.int32),
                             qt.output_zero_point.to(torch.int32)]).reshape(2),
        x_shift=0 if in_spec.quant_type.is_signed else 128,
        iq=in_spec.quant_type.qrange(in_spec.symmetric, in_spec.reduce_range),
        oq=out_spec.quant_type.qrange(out_spec.symmetric, out_spec.reduce_range),
    )
    qt.__dict__["_q8_constants"] = consts
    return consts


def q8_matmul_plain(x2d: torch.Tensor, data: torch.Tensor, bias: torch.Tensor | None,
                    c: Q8Constants) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the kernel's operands.

    x2d (M, K) float32 or bfloat16; data (K, N) int8, or uint8 shifted by
    128 here; bias (N,) int32 or None. The integer dot runs as float32
    products over chunks of at most 256 rows (exact; TF32 must be off on a
    card), summed in int32; the epilogue is the kernel's, one rounded
    operation at a time. Returns (M, N) float32.
    """
    M, K = x2d.shape
    xs, ys = c.fparams[0], c.fparams[1]
    x_zp, y_zp = c.iparams[0], c.iparams[1]
    x_q = torch.clamp(torch.round(x2d.to(torch.float32) / xs).to(torch.int32) + x_zp,
                      *c.iq) - c.x_shift
    w = data.to(torch.float32)
    if data.dtype == torch.uint8:
        w = w - 128.0
    xf = x_q.to(torch.float32)
    acc = torch.zeros((M, data.shape[1]), dtype=torch.int32, device=x2d.device)
    for r0 in range(0, K, _EXACT_ROWS):
        acc += torch.matmul(xf[:, r0:r0 + _EXACT_ROWS], w[r0:r0 + _EXACT_ROWS]).to(torch.int32)
    x_zp_eff = x_zp - c.x_shift
    acc = (acc - x_zp_eff * c.wsum - c.wzp * x_q.sum(dim=1, dtype=torch.int32)[:, None]
           + K * x_zp_eff * c.wzp)
    if bias is not None:
        acc = acc + bias
    y_zp_f = y_zp.to(torch.float32)
    y_q = torch.clamp(torch.round(acc.to(torch.float32) * c.req) + y_zp_f, *c.oq)
    return (y_q - y_zp_f) * ys


def _check_operands(x2d, data, bias, c):
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q8_matmul: x must be float32 or bfloat16, got {x2d.dtype}")
    if data.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"q8_matmul: data must be int8 or uint8, got {data.dtype}")
    if x2d.ndim != 2 or data.ndim != 2 or x2d.shape[1] != data.shape[0]:
        raise ValueError(f"q8_matmul: x {tuple(x2d.shape)} does not match data "
                         f"{tuple(data.shape)}")
    N = data.shape[1]
    want = ((c.wsum, torch.int32, (N,)), (c.wzp, torch.int32, (N,)),
            (c.req, torch.float32, (N,)), (c.fparams, torch.float32, (2,)),
            (c.iparams, torch.int32, (2,)))
    if bias is not None:
        want += ((bias, torch.int32, (N,)),)
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"q8_matmul: a constant is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    for t in (x2d, data) + tuple(t for t, _, _ in want):
        if t.device != x2d.device:
            raise ValueError("q8_matmul: operands on different devices")
        if not t.is_contiguous():
            raise ValueError("q8_matmul: operands must be contiguous")


def q8_matmul(x2d: torch.Tensor, data: torch.Tensor, bias: torch.Tensor | None,
              c: Q8Constants) -> torch.Tensor:
    """Launch the Q8 kernel on CUDA tensors; CPU tensors get the plain version.

    Operands as :func:`q8_matmul_plain`; returns (M, N) float32.
    """
    _check_operands(x2d, data, bias, c)
    if x2d.device.type == "cpu":
        return q8_matmul_plain(x2d, data, bias, c)
    if x2d.device.type != "cuda":
        raise ValueError(f"q8_matmul: unsupported device {x2d.device}")
    M, K = x2d.shape
    N = data.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x2d.device)
    if M == 0 or N == 0:
        return out
    if data.data_ptr() % 4:
        raise ValueError("q8_matmul: data must be 4-byte aligned")
    if K >= MAX_K:
        raise ValueError(f"q8_matmul: K = {K} could overflow the int32 dot (K < {MAX_K})")
    sms = torch.cuda.get_device_properties(x2d.device).multi_processor_count
    plan = q8_plan(M, K, N, sms)
    if plan.route == "mma" and data.data_ptr() % CP_ASYNC_BYTES:
        plan = _simt_plan(M, N, sms)  # a view at an odd offset: no 16-byte copies
    ws = counters = None
    if plan.splits > 1:
        ws, counters = split_scratch(x2d.device, plan)
    err = kernel_library().oqt_q8_matmul(
        ptr(x2d), int(x2d.dtype == torch.bfloat16), ptr(data), ptr(c.wsum), ptr(c.wzp),
        ptr(c.req), ptr(bias), ptr(c.fparams), ptr(c.iparams), ptr(out), M, K, N,
        int(data.dtype == torch.int8), c.x_shift, *c.iq, *c.oq, int(plan.route == "mma"),
        plan.bm, plan.bn, plan.split_slices, ptr(ws), ptr(counters), stream_ptr(x2d.device),
    )
    check_launch(err, "oqt_q8_matmul")
    global launches
    launches += 1
    return out


def q8_operands(x: torch.Tensor, qt: QTensor, bias: QBias | None = None) -> tuple:
    """The (x2d, data, bias, constants) operands that :func:`q8_matmul` and
    its plain version take for one QLINEAR site."""
    K, _ = qt.meta.shape
    if bias is not None and not isinstance(bias, QBias):
        raise TypeError("A QLINEAR Gemm site requires an int32-quantized bias (QBias).")
    b = None if bias is None else bias.data.to(torch.int32).contiguous()
    return x.reshape(-1, K).contiguous(), qt.data.contiguous(), b, q8_constants(qt)


def q8_qlinear_matmul(x: torch.Tensor, qt: QTensor, bias: QBias | None = None) -> torch.Tensor:
    """One QLINEAR site through the Q8 kernel. x: (..., K) -> (..., N) float32."""
    return q8_matmul(*q8_operands(x, qt, bias)).reshape(*x.shape[:-1], qt.meta.shape[1])


def _q8_predicate(x, qt: QTensor, bias) -> bool:
    if qt.meta.fmt != QFormat.QLINEAR:
        return False
    return qt.input_scale is not None and qt.output_scale is not None


@register_kernel(_q8_predicate)
def _q8_kernel_entry(x, qt: QTensor, bias):
    return q8_qlinear_matmul(x, qt, bias)
