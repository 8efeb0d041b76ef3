"""The port's counterparts of ``tests/helpers.py``'s tiny models, for tests
that run the same params through both packages (bridge the JAX helper's
``random_params`` with ``interop.from_jax_params``)."""

from __future__ import annotations

import numpy as np

from onnx_quantize_tpu_torch import nn as tnn
from onnx_quantize_tpu_torch.nn.module import InputSpec


class TwoMatMul(tnn.Module):
    """x @ W1 @ W2: two sites, with a bias each when ``bias`` (the JAX
    helpers' ``TwoMatMul`` and ``GemmModel``)."""

    def __init__(self, d_in=16, d_mid=32, d_out=8, bias=False):
        super().__init__()
        self.fc1 = tnn.Linear(d_in, d_mid, use_bias=bias)
        self.fc2 = tnn.Linear(d_mid, d_out, use_bias=bias)
        self.input_specs = [InputSpec("input", (d_in,))]
        self.finalize()

    def forward(self, params, x, ctx=None):
        return self.fc2(params["fc2"], self.fc1(params["fc1"], x, ctx=ctx), ctx=ctx)


def assert_trees_equal(ours, theirs, path=()):
    """Every leaf of a JAX param tree equal, bit for bit, to the port's
    (same keys, shapes and dtypes)."""
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), (path, sorted(ours), sorted(theirs))
        for k in theirs:
            assert_trees_equal(ours[k], theirs[k], path + (k,))
        return
    a = np.asarray(theirs)
    b = ours.detach().cpu().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, path
    assert a.tobytes() == b.tobytes(), path
