"""The plain float32 reference that decides ``correct``.

It imports neither JAX nor anything of onnx_quantize_tpu_torch, and takes
nothing the program made: it draws the same float weights from the seed
(``benchlib.weights``), quantizes them again with its own copy of RTN
(``rtn.py``) and runs the decoder in float32 with TF32 off, layer by layer
(``model.py``). ``judge.py`` turns its logits into the numbers compared.
"""
