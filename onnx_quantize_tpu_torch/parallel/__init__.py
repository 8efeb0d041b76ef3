"""Tensor, expert, pipeline and context parallelism on ``torch.distributed``.

Counterpart of ``onnx_quantize_tpu/parallel``. One process per rank: the
caller (``torchrun``, a test, ``chip_smoke.py``) starts the ranks and
initialises the default process group; this package spawns nothing. Every
rank calls a function with the same global inputs and takes its own shard by
its mesh coordinates (``mesh.py``), runs its local part with the Hopper
kernels at the local shapes and the collectives of ``comm.py``, and returns
the JAX function's result (or its block of it, where that is split).
"""

from onnx_quantize_tpu_torch.parallel.cp import (
    cp_logits,
    cp_tp_logits,
    make_cp_forward,
    make_cp_mesh,
    make_cp_tp_mesh,
    zigzag_permutation,
)
from onnx_quantize_tpu_torch.parallel.ep import a2a_moe_mlp
from onnx_quantize_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated
from onnx_quantize_tpu_torch.parallel.pp import (
    make_pipeline_mesh,
    pipeline_stage_params,
    pp_logits,
)
from onnx_quantize_tpu_torch.parallel.sharding import (
    GEMMA3_TP_RULES,
    qtensor_shardings,
    shard_params,
)
from onnx_quantize_tpu_torch.parallel.tp import build_param_specs, localize_params, site_kind

__all__ = [
    "a2a_moe_mlp",
    "cp_logits",
    "cp_tp_logits",
    "make_cp_forward",
    "make_cp_mesh",
    "make_cp_tp_mesh",
    "zigzag_permutation",
    "make_pipeline_mesh",
    "pipeline_stage_params",
    "pp_logits",
    "make_mesh",
    "data_sharding",
    "replicated",
    "GEMMA3_TP_RULES",
    "qtensor_shardings",
    "shard_params",
    "build_param_specs",
    "localize_params",
    "site_kind",
]
