"""The benchmark of onnx_quantize_tpu_torch on NVIDIA H100 cards.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that belongs
to one model configuration, traffic mix or per-layer metric sits in a file
of its own (``configs/``, ``traffic/`` with ``drivers/``, ``metrics/``,
``limits/``), found by the name the cell gives. ``benchlib/`` is the shared
yardstick (weights from the seed, statistics, the roofline arithmetic, the
trace reductions) and ``reference/`` the plain float32 model that decides
``correct``. Nothing here imports JAX or the JAX package.
"""
