"""The port's tensor-parallel matmuls (``parallel/tp_ops.py``) and pipelined
collectives (``parallel/collective.py``) on worlds of gloo ranks on the CPU,
held to the JAX package's functions on a 2- and a 4-device mesh, and the
collectives module (``parallel/comm.py``) on a (data 2, model 2) mesh.

Every rank calls with the global input and weight; a result that JAX
replicates is compared whole on every rank, one that JAX splits is compared
as the rank's block of it. Tolerances: the JAX tests' own, 1e-5 abs where a
rank sums one K block, 1e-4 where the sum crosses ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy
from onnx_quantize_tpu.nn.qtensor import make_qtensor
from onnx_quantize_tpu.parallel import collective as jcollective
from onnx_quantize_tpu.parallel import make_mesh as jmake_mesh
from onnx_quantize_tpu.parallel import tp_ops as jtp_ops
from onnx_quantize_tpu_torch.interop import from_jax_params

from .torch_world import result, run_world

torch.set_num_threads(1)

SIZES = (2, 4)
# name -> (port function, which block of JAX's result a rank holds, atol)
OPS = {"column": ("column", None, 1e-5), "column_bias": ("column", None, 1e-5),
       "column_local": ("column", "cols", 1e-5), "row": ("row", None, 1e-4),
       "row_bias": ("row", None, 1e-4), "pair": ("pair", None, 1e-4),
       "allgather": ("allgather", "cols", 1e-5), "allgather_int8": ("allgather", "cols", 1e-5),
       "reduce_scatter": ("reduce_scatter", "rows", 1e-4),
       "sp_pair": ("sp_pair", "rows", 1e-4)}


def _qt(rng, K, N, qt_type=QuantType.QUInt4, gs=16):
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    strategy = QuantizationStrategy.GROUP if gs > 0 else QuantizationStrategy.CHANNEL
    q, s, zp = rtn_quantize(w, qt_type, strategy, gs, False, False)
    return make_qtensor(q, s, zp, quant_type=qt_type, strategy=strategy, group_size=gs,
                        symmetric=False, reduce_range=False)


def cases_for(n: int):
    """(JAX results, the port's op arguments) at tp = n, the JAX tests' shapes."""
    rng = np.random.default_rng(n)
    mesh = jmake_mesh(model_parallel=n, devices=jax.devices()[:n])
    gelu = jax.nn.gelu
    up, down = _qt(rng, 64, 256), _qt(rng, 256, 64)
    col, row = _qt(rng, 64, 256), _qt(rng, 128, 128)
    col8 = _qt(rng, 64, 256, qt_type=QuantType.QInt8, gs=-1)
    rs = _qt(rng, n * 64, 128)
    sp_up, sp_down = _qt(rng, 64, n * 64), _qt(rng, n * 64, 64)
    x8 = rng.standard_normal((8, 64)).astype(np.float32)
    x16 = rng.standard_normal((16, 64)).astype(np.float32)
    x_row = rng.standard_normal((8, 128)).astype(np.float32)
    h = rng.standard_normal((16, n * 64)).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    bias_row = rng.standard_normal(128).astype(np.float32)
    jx = {k: jnp.asarray(v) for k, v in dict(x8=x8, x16=x16, x_row=x_row, h=h, bias=bias,
                                              bias_row=bias_row).items()}
    want = {
        "column": jtp_ops.column_parallel_matmul(jx["x8"], col, mesh),
        "column_bias": jtp_ops.column_parallel_matmul(jx["x8"], col, mesh, bias=jx["bias"]),
        "column_local": jtp_ops.column_parallel_matmul(jx["x8"], col, mesh,
                                                       gather_output=False),
        "row": jtp_ops.row_parallel_matmul(jx["x_row"], row, mesh),
        "row_bias": jtp_ops.row_parallel_matmul(jx["x_row"], row, mesh, bias=jx["bias_row"]),
        "pair": jtp_ops.tp_pair_matmul(jx["x8"], up, down, mesh, activation=gelu),
        "allgather": jcollective.allgather_matmul(jx["x16"], col, mesh),
        "allgather_int8": jcollective.allgather_matmul(jx["x8"], col8, mesh),
        "reduce_scatter": jcollective.matmul_reduce_scatter(jx["h"], rs, mesh),
        "sp_pair": jcollective.sequence_parallel_pair(jx["x16"], sp_up, sp_down, mesh,
                                                      activation=gelu),
    }
    t = {k: torch.from_numpy(v) for k, v in dict(x8=x8, x16=x16, x_row=x_row, h=h, bias=bias,
                                                  bias_row=bias_row).items()}
    p = {k: from_jax_params(v, device="cpu") for k, v in dict(
        up=up, down=down, col=col, row=row, col8=col8, rs=rs, sp_up=sp_up,
        sp_down=sp_down).items()}
    ops = {
        "column": ("column", (t["x8"], p["col"]), {}),
        "column_bias": ("column", (t["x8"], p["col"]), {"bias": t["bias"]}),
        "column_local": ("column", (t["x8"], p["col"]), {"gather_output": False}),
        "row": ("row", (t["x_row"], p["row"]), {}),
        "row_bias": ("row", (t["x_row"], p["row"]), {"bias": t["bias_row"]}),
        "pair": ("pair", (t["x8"], p["up"], p["down"]), {"activation": "gelu"}),
        "allgather": ("allgather", (t["x16"], p["col"]), {}),
        "allgather_int8": ("allgather", (t["x8"], p["col8"]), {}),
        "reduce_scatter": ("reduce_scatter", (t["h"], p["rs"]), {}),
        "sp_pair": ("sp_pair", (t["x16"], p["sp_up"], p["sp_down"]), {"activation": "gelu"}),
    }
    return {k: np.asarray(v) for k, v in want.items()}, ops


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wants, cases = {}, {"comm": ("comm", {})}
    for n in SIZES:
        wants[n], ops = cases_for(n)
        cases[f"tp{n}"] = ("tp_ops", dict(tp=n, ops=ops))
    return run_world(4, cases, tmp_path_factory.mktemp("tp_ops")), wants


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", list(OPS))
def test_tp_op_matches_jax(world, n, op):
    results, wants = world
    _, block, atol = OPS[op]
    want = wants[n][op]
    for rank in range(n):
        got = result(results, f"tp{n}", rank)[op]
        if block == "cols":
            w = want.shape[1] // n
            want_r = want[:, rank * w:(rank + 1) * w]
        elif block == "rows":
            m = want.shape[0] // n
            want_r = want[rank * m:(rank + 1) * m]
        else:
            want_r = want
        assert got.shape == want_r.shape, (rank, got.shape, want_r.shape)
        np.testing.assert_allclose(got, want_r, atol=atol, err_msg=f"rank {rank}")
    for rank in range(n, 4):
        assert results[rank][f"tp{n}"] is None


def test_mesh_layout_and_groups(world):
    results, _ = world
    for rank in range(4):
        got = result(results, "comm", rank)
        assert got["shape"] == {"data": 2, "model": 2} and got["backend"] == "gloo"
        assert got["coords"] == {"data": rank // 2, "model": rank % 2}
        assert got["index"] == (rank // 2, rank % 2) and got["size"] == (2, 2)
        assert got["members"] == {"data": [rank % 2, rank % 2 + 2],
                                  "model": [rank - rank % 2, rank - rank % 2 + 1]}


def test_collectives_over_mesh_axes(world):
    results, _ = world
    for rank in range(4):
        got = result(results, "comm", rank)
        pair = rank - rank % 2  # the model group's first rank
        np.testing.assert_array_equal(got["all_reduce"], np.full((2, 3), 2.0 * pair + 1))
        col = rank % 2
        np.testing.assert_array_equal(got["all_gather"], np.concatenate(
            [np.full((2, 3), float(col)), np.full((2, 3), float(col + 2))], axis=1))
        me = rank % 2
        np.testing.assert_array_equal(got["all_to_all"][:, 0],
                                      [me + 10.0 * pair, me + 10.0 * (pair + 1)])
        np.testing.assert_array_equal(got["ring"], np.full((2, 3), float(pair + 1 - rank % 2)))
        # Only data coordinate 0 sends: coordinate 1 receives its peer's, 0 gets zeros.
        want = 0.0 if rank < 2 else float(rank - 2)
        np.testing.assert_array_equal(got["one_way"], np.full((2, 3), want))
        stats = got["stats"]
        assert stats["calls"] == 5 and stats["staged_calls"] == 0  # CPU tensors: no staging
        assert stats["ops"] == {"all_reduce": 1, "all_gather": 1, "all_to_all": 1,
                                "ppermute": 2}


def test_mesh_refuses_ranks_sharing_a_device_under_nccl(world):
    """The check a mesh runs under nccl: ranks that report one device raise,
    with a message that names gloo; the mesh never switches backend."""
    results, _ = world
    for rank in range(4):
        message = result(results, "comm", rank)["shared_device"]
        assert message is not None and "share a device" in message and "gloo" in message
