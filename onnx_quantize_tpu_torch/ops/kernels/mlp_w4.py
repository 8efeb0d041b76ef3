"""Fused W4 GeGLU MLP (decode path): CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``onnx_quantize_tpu/ops/kernels/mlp_w4.py``
(``_mlp_call`` -> ``_mlp_kernel``) with ``csrc/mlp_w4.cu``. One launch
computes the whole Gemma MLP over two packed-W4 weights:

    h   = x @ dequant(W_gate_up)          # (M, 2I), float32
    act = gelu_tanh(h[:, :I]) * h[:, I:]  # float32, rounded to x's dtype
    y   = act @ dequant(W_down)           # (M, N), float32

The kernel splits I across blocks and sums their partial outputs inside
the launch in a fixed order. :func:`mlp_w4_plan` picks the route: bf16 x
runs on W4's tensor-core core (one block per 16 intermediate columns of the
gate-up product; in the down product each block of a thread block cluster
takes its share of y's columns over the cluster's act, and the clusters'
partials are summed by the last to finish), float32 x and other shapes on
the CUDA cores (the first port's kernel); the source note in
``csrc/mlp_w4.cu`` gives the design. ``mlp_w4_eligible`` is the reference's
predicate, TPU-set limits included (M <= 256 and a 10 MB VMEM estimate), so
the port takes the same sites; ``PERF.md`` lists both limits as open
questions for the H100.

What bounds it on the card: at Gemma-3-270M decode the two packed weights
and their scales are ~2.6 MB a layer, ~0.8 us at 3.35 TB/s; the kernel is a
chain of dependent steps, so latency sets its time. ``chip_smoke.py`` times
it beside the unfused pair it replaces (W4 gate_up, GeGLU, W4 down); no
single PyTorch call computes the same function.
"""

from __future__ import annotations

import dataclasses

import torch

from onnx_quantize_tpu_torch.core.enums import QFormat
from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.ops.kernels import (
    check_launch,
    kernel_library,
    pad_to_multiple,
    ptr,
    split_scratch,
    stream_ptr,
)
from onnx_quantize_tpu_torch.ops.kernels.matmul_w4 import (
    expand_w4_scales,
    w4_dequant_matmul_plain,
)

__all__ = ["MlpW4Plan", "mlp_w4_plan", "simt_plan", "mlp_w4_eligible", "mlp_w4_fused",
           "mlp_w4_reference", "mlp_w4", "mlp_w4_plain", "mlp_w4_operands", "launch"]

# Kernel launches since import (or since a caller reset it); counts only
# launches of the CUDA kernel, never the plain version.
launches = 0
route_launches = {"mma": 0, "simt": 0}

# Intermediate columns a block: the mma route's slice (the down product's mma
# K) and the simt route's (one a lane); csrc/mlp_w4.cu.
MMA_TJ = 16
SIMT_TJ = 32
MMA_WARPS = 8
MAX_CLUSTER = 16  # the largest thread block cluster (beyond 8 non-portable)
MAX_PAIRS = 16  # gate-up group pairs: one x mbarrier each
# Bytes of one cp.async copy: the mma route stages every operand in such
# chunks, so it needs 16-byte-aligned operands.
CP_ASYNC_BYTES = 16
# Shared memory a block may use on the H100 (227 KB).
SMEM_LIMIT = 232448


@dataclasses.dataclass(frozen=True)
class MlpW4Plan:
    """How one fused-MLP call launches. ``route`` "mma" (bf16 x on the tensor
    cores) or "simt" (the CUDA cores); ``tj`` intermediate columns a block,
    ``blocks`` of ``warps`` warps; M walked in ``passes`` of ``bm`` rows;
    ``cluster`` blocks a thread block cluster (mma; 1 for simt), each block
    of a cluster owning N / cluster columns of y in the down product;
    ``tiles`` counters and ``scratch_elems`` 4-byte elements of scratch
    (``ops/kernels/__init__.py::split_scratch``; none when 0); ``smem_bytes``
    of dynamic shared memory a block (mma)."""

    route: str
    tj: int
    warps: int
    bm: int
    cluster: int
    blocks: int
    passes: int
    tiles: int
    scratch_elems: int
    smem_bytes: int

    @property
    def splits(self) -> int:
        """Partials of y summed across the grid: a cluster's (mma), a
        block's (simt)."""
        return self.blocks // self.cluster


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _mma_smem_bytes(bm: int, K_pad: int, N: int, gs_g: int, cluster: int) -> int:
    """Dynamic shared memory of an mma-route block (``MmaSmem`` in
    ``csrc/mlp_w4.cu``): the gate-up rows (48 bytes each) and their scales;
    the down rows and scales of the block's N / cluster columns for each of
    the cluster's 16-column K steps; its act tile; and a union of the pass's
    x tile and h tile (two K halves) with the cluster's gathered act tiles
    and the warps' partials of y."""
    ncols = N // cluster
    words = ncols // 4
    wd_pitch = 4 * (words + (4 - words) % 8)
    fixed = ((K_pad // 2) * 48 + (K_pad // (2 * gs_g)) * 512 + cluster * MMA_TJ * wd_pitch
             + cluster * 2 * ncols * 4 + bm * 48)
    phase1 = bm * (K_pad + 8) * 2 + 2 * bm * 33 * 4
    phase2 = cluster * bm * 48 + MMA_WARPS * bm * (ncols + 4) * 4
    return fixed + max(phase1, phase2)


def mlp_w4_plan(M: int, K_pad: int, inter: int, N: int, gs_g: int, gs_d: int,
                x_dtype: torch.dtype) -> MlpW4Plan:
    """The launch plan of ``csrc/mlp_w4.cu`` for x (M, K_pad) of ``x_dtype``,
    ``inter`` intermediate columns and N outputs, gate-up and down group
    sizes ``gs_g`` and ``gs_d``.

    bf16 x with ``gs_g``, ``gs_d`` and ``inter`` multiples of 16, N of 8 and
    at most 16 gate-up group pairs takes the mma route when its shared
    memory fits: ``inter / 16`` blocks of 8 warps, passes of 16 rows of M
    (M <= 16) or 32, clusters of the largest size <= 16 that divides the
    block count and leaves each block whole 8-column n-tiles of y
    (Gemma-3-270M: 8 clusters of 16, 40 columns a block, 108 KB of shared
    memory, so two blocks fit an SM). Scratch holds
    one (M, N) partial a cluster when there is more than one, and a counter
    a (pass, cluster rank). Anything else takes the simt route.
    """
    if (x_dtype == torch.bfloat16 and gs_g % MMA_TJ == 0 and gs_d % MMA_TJ == 0
            and inter % MMA_TJ == 0 and N % 8 == 0 and inter > 0 and N > 0
            and K_pad // (2 * gs_g) <= MAX_PAIRS):
        bm = 16 if M <= 16 else 32
        blocks = inter // MMA_TJ
        cluster = max(c for c in range(1, MAX_CLUSTER + 1)
                      if blocks % c == 0 and N % (8 * c) == 0)
        passes = _ceil(M, bm)
        smem = _mma_smem_bytes(bm, K_pad, N, gs_g, cluster)
        if smem <= SMEM_LIMIT:
            clusters = blocks // cluster
            tiles = passes * cluster if clusters > 1 else 0
            scratch = clusters * passes * bm * N if clusters > 1 else 0
            return MlpW4Plan("mma", MMA_TJ, MMA_WARPS, bm, cluster, blocks, passes, tiles,
                             scratch, smem)
    return simt_plan(M, inter, N)


def simt_plan(M: int, inter: int, N: int) -> MlpW4Plan:
    """The CUDA-core route: ``inter / 32`` blocks (a cooperative launch with
    a grid barrier), passes of 32 rows; scratch holds each block's (M, N)
    partial (M rounded up to 32, so few sizes are cached) and two counters."""
    passes = _ceil(M, 32)
    blocks = inter // SIMT_TJ
    return MlpW4Plan("simt", SIMT_TJ, 8, 32, 1, blocks, passes, 2, blocks * passes * 32 * N, 0)


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
    if gs_g <= 0 or half_g % gs_g or K_pad != 2 * half_g or n2 % 2:
        raise ValueError(f"mlp_w4: x {tuple(x2d.shape)} does not match gate-up data "
                         f"{tuple(wg.shape)} with group size {gs_g}")
    if gs_d <= 0 or half_d % gs_d or 2 * half_d < inter:
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
    inter, N = wg.shape[1] // 2, wd.shape[1]
    plan = mlp_w4_plan(M, K_pad, inter, N, gs_g, gs_d, x2d.dtype)
    if plan.route == "mma" and any(t.data_ptr() % CP_ASYNC_BYTES
                                   for t in (x2d, wg, sg, zg, wd, sd, zd)):
        plan = simt_plan(M, inter, N)  # a view at an odd offset: no 16-byte copies
    return launch(x2d, wg, sg, zg, wd, sd, zd, plan=plan, **kw)


def launch(x2d, wg, sg, zg, wd, sd, zd, *, gs_g: int, gs_d: int, signed_g: bool,
           signed_d: bool, plan: MlpW4Plan) -> torch.Tensor:
    """Launch the kernel on checked CUDA operands by ``plan`` (the wrapper's
    :func:`mlp_w4_plan`, or :func:`simt_plan` to compare the routes)."""
    M, K_pad = x2d.shape
    inter, N = wg.shape[1] // 2, wd.shape[1]
    if plan.route == "simt" and (inter % SIMT_TJ or gs_d % SIMT_TJ):
        raise ValueError(f"mlp_w4: the CUDA-core route takes {inter} intermediate columns and "
                         f"down group size {gs_d} only as multiples of {SIMT_TJ}")
    out = torch.empty((M, N), dtype=torch.float32, device=x2d.device)
    if M == 0 or N == 0:
        return out
    ws = counters = None
    if plan.tiles:
        ws, counters = split_scratch(x2d.device, plan)
    err = kernel_library().oqt_mlp_w4(
        ptr(x2d), int(x2d.dtype == torch.bfloat16), ptr(wg), ptr(sg), ptr(zg), ptr(wd), ptr(sd),
        ptr(zd), ptr(ws), ptr(counters), ptr(out), M, K_pad, inter, N, gs_g, gs_d,
        int(signed_g), int(signed_d), int(plan.route == "mma"), plan.bm, plan.cluster,
        stream_ptr(x2d.device),
    )
    check_launch(err, "oqt_mlp_w4")
    global launches
    launches += 1
    route_launches[plan.route] += 1
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
