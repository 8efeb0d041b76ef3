"""Functional modules: structure in ``torch.nn.Module``, params in a dict tree.

Counterpart of ``onnx_quantize_tpu/nn/module.py``. A model is a tree of
:class:`Module` objects that hold configuration only; its parameters are a
separate nested dict mirroring the tree, as in the JAX package. That keeps
``quantize(model, params, qconfig)`` a pure tree transform (float leaves
become :class:`QTensor` leaves) and lets a param tree from the JAX package be
bridged leaf by leaf (``interop.from_jax_params``).

Children held in a ``torch.nn.ModuleList`` named ``layers`` appear in the
param tree under the keys ``layers.0``, ``layers.1``, ... (the JAX package's
keys), and quantizable sites are named by their dotted path
(``layers.0.attn.q_proj``).

Calibration taps: a forward given a :class:`Context` whose ``taps`` dict is
set records each target site's input (after its ``prescale``, the input the
quantized weight sees) and output under its site name, as the JAX package's
taps do.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from onnx_quantize_tpu_torch.nn.qtensor import QTensor
from onnx_quantize_tpu_torch.plan import LinearSite

__all__ = ["Context", "InputSpec", "Module", "Linear"]


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """A declared model input, for random calibration data: ``shape``
    excludes the batch dimension; integer dtypes (numpy) are sampled in
    [0, 100), floats from a standard normal."""

    name: str
    shape: tuple[int, ...]
    dtype: Any = np.float32


@dataclasses.dataclass
class Context:
    """Per-call execution context: activation tap collection."""

    taps: dict[str, dict[str, torch.Tensor]] | None = None
    tap_inputs: bool = False
    tap_outputs: bool = False
    tap_names: set[str] | None = None  # None = all target sites

    def collect(self, name: str, kind: str, value: torch.Tensor) -> None:
        if self.taps is None:
            return
        if kind == "input" and not self.tap_inputs:
            return
        if kind == "output" and not self.tap_outputs:
            return
        if self.tap_names is not None and name not in self.tap_names:
            return
        self.taps.setdefault(name, {})[kind] = value


class Module(torch.nn.Module):
    """Base module: ``init(generator)`` builds its params dict; ``finalize``
    names every module by its dotted path (idempotent)."""

    # Declared inputs (for random calibration data); models override.
    input_specs: list[InputSpec] | None = None
    site_name: str | None = None

    def finalize(self, prefix: str = "") -> "Module":
        self.site_name = prefix
        for key, child in self._param_children():
            child.finalize(f"{prefix}.{key}" if prefix else key)
        return self

    def _param_children(self):
        """(param-tree key, child) pairs, flattening ModuleLists."""
        for key, child in self.named_children():
            if isinstance(child, torch.nn.ModuleList):
                for i, sub in enumerate(child):
                    yield f"{key}.{i}", sub
            else:
                yield key, child

    def init(self, generator: torch.Generator) -> dict:
        """Params for this module's children, on ``generator.device``."""
        return {key: child.init(generator) for key, child in self._param_children()}

    def linear_sites(self) -> list[LinearSite]:
        if self.site_name is None:
            self.finalize()
        sites: list[LinearSite] = []
        self._collect_sites((), sites)
        return sites

    def _collect_sites(self, path: tuple[str, ...], out: list[LinearSite]) -> None:
        for key, child in self._param_children():
            child._collect_sites(path + (key,), out)


class Linear(Module):
    """y = x @ w (+ b): the quantizable site.

    Weight layout is ``(in_features, out_features)``.
    """

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = use_bias
        self.dtype = dtype
        # Row-parallel marker (set by ``tp_localize``): the name of the mesh
        # axis whose ranks each hold a K shard; the local product is summed
        # over it before the bias is added (the Megatron row-parallel site).
        self.tp_reduce: str | None = None

    @property
    def op_type(self) -> str:
        return "Gemm" if self.use_bias else "MatMul"

    def init(self, generator: torch.Generator) -> dict:
        # Truncated normal (sigma=0.1, clip 2.5 sigma), as the JAX package.
        w = torch.empty((self.in_features, self.out_features), dtype=torch.float32,
                        device=generator.device)
        torch.nn.init.trunc_normal_(w, std=1.0, a=-2.5, b=2.5, generator=generator)
        params = {"w": (0.1 * w).to(self.dtype)}
        if self.use_bias:
            params["b"] = torch.zeros((self.out_features,), dtype=self.dtype,
                                      device=generator.device)
        return params

    def _collect_sites(self, path: tuple[str, ...], out: list[LinearSite]) -> None:
        out.append(LinearSite(
            name=".".join(path), op_type=self.op_type, param_path=path,
            in_features=self.in_features, out_features=self.out_features,
        ))

    def forward(self, params: dict, x: torch.Tensor, ctx: Context | None = None) -> torch.Tensor:
        return apply_linear(params, x, ctx, self.site_name, tp_reduce=self.tp_reduce)


def apply_linear(params: dict, x: torch.Tensor, ctx: Context | None = None,
                 name: str | None = None, tp_reduce: str | None = None) -> torch.Tensor:
    """Linear-site semantics on a site dict: the input ``prescale`` (the
    folded SmoothQuant/AWQ scale), float32 accumulation, then the result cast
    back to the stream dtype (a bf16 residual stream stays bf16 through every
    site). With ``tp_reduce`` (a mesh axis name) the float32 product is
    summed over that axis's ranks before the bias is added. With a ``ctx``,
    the calibration taps record the site's input after the prescale, and its
    output, under ``name``."""
    from onnx_quantize_tpu_torch.ops import quantized_matmul

    # The stream dtype is read before the prescale multiply: a float32
    # prescale promotes a bf16 stream, and the cast back keeps it bf16.
    in_dtype = x.dtype
    prescale = params.get("prescale")
    if prescale is not None:
        x = (x * prescale).to(in_dtype)
    if ctx is not None:
        ctx.collect(name, "input", x)
    w = params["w"]
    b = params.get("b")
    if tp_reduce is not None:
        from onnx_quantize_tpu_torch.parallel.comm import all_reduce

        if isinstance(w, QTensor):
            y = quantized_matmul(x, w, None)
        else:
            dt = torch.promote_types(x.dtype, w.dtype)
            y = torch.matmul(x.to(dt), w.to(dt)).to(torch.float32)
        y = all_reduce(y, tp_reduce)
        if b is not None:
            y = y + b
    elif isinstance(w, QTensor):
        y = quantized_matmul(x, w, b)
    else:
        # Mixed dtypes promote, as in JAX: a pre-pass leaves a float32 weight
        # in a bf16 stream until the weight is quantized.
        dt = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt)).to(torch.float32)
        if b is not None:
            y = y + b
    y = y.to(in_dtype)
    if ctx is not None:
        ctx.collect(name, "output", y)
    return y
