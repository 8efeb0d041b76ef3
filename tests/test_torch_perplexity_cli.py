"""The port's perplexity command line (``tools/perplexity.py::main``).

Counterpart of the JAX tool's ``main`` (``onnx_quantize_tpu/tools/
perplexity.py:148-189``): ``--checkpoint`` reloads a framework checkpoint,
``--hf-weights`` imports a local HF Gemma-3 directory, ``--tokens`` reads a
pre-tokenized stream, ``--cpu`` keeps it on the CPU, and it prints
``perplexity: X.XXXX``, equal to ``perplexity_from_tokens`` on the same tree.
The module imports no JAX (read from its source, as
``test_torch_no_jax.py`` reads every port file).
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.checkpoint import save_checkpoint
from onnx_quantize_tpu_torch.models import gemma3
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3, Gemma3Config
from onnx_quantize_tpu_torch.tools import perplexity
from onnx_quantize_tpu_torch.tools.perplexity import perplexity_from_tokens

from .test_torch_import_hf import save_shards, synthetic_hf_tensors

CFG = Gemma3Config.tiny()
WINDOW = ["--max-length", "32", "--stride", "16", "--cpu"]


def printed_ppl(capsys) -> float:
    out = capsys.readouterr().out
    match = re.fullmatch(r"perplexity: (\d+\.\d{4})\n", out)
    assert match, out
    return float(match.group(1))


@pytest.fixture
def tokens(tmp_path):
    path = tmp_path / "tokens.npy"
    stream = np.random.default_rng(0).integers(1, CFG.vocab_size, 100).astype(np.int32)
    np.save(path, stream)
    return str(path), stream


def test_checkpoint_arm_prints_perplexity_from_tokens(tmp_path, tokens, capsys):
    """A W4 tree saved with save_checkpoint, scored from the command line."""
    path, stream = tokens
    model = Gemma3(CFG)
    params = model.init(torch.Generator().manual_seed(0))
    q, _ = oqt.quantize(model, params, oqt.QConfig(
        weights=oqt.QWeightArgs(dtype="uint4", group_size=32), ignore=["lm_head"]))
    save_checkpoint(str(tmp_path / "ckpt"), model, q)
    got = perplexity.main(["--checkpoint", str(tmp_path / "ckpt"), "--tokens", path, *WINDOW])
    assert printed_ppl(capsys) == round(got, 4)
    assert got == perplexity_from_tokens(model, q, stream, max_length=32, stride=16)


def test_hf_weights_arm(tmp_path, tokens, capsys, monkeypatch):
    """--hf-weights builds Gemma-3-270M; a tiny config stands in for it here."""
    path, stream = tokens
    monkeypatch.setattr(gemma3, "GEMMA3_270M", CFG)
    tensors = synthetic_hf_tensors(CFG, np.random.default_rng(1))
    tensors = {k: 0.1 * v for k, v in tensors.items()}
    save_shards(tensors, tmp_path / "hf", shards=2)
    got = perplexity.main(["--hf-weights", str(tmp_path / "hf"), "--tokens", path, *WINDOW])
    assert printed_ppl(capsys) == round(got, 4)
    from onnx_quantize_tpu_torch.models.import_hf import load_gemma3_hf

    model = Gemma3(CFG)
    params = load_gemma3_hf(model, str(tmp_path / "hf"), device="cpu")
    assert np.isfinite(got) and got == perplexity_from_tokens(model, params, stream,
                                                              max_length=32, stride=16)


def test_needs_one_weight_source(tokens):
    with pytest.raises(SystemExit):
        perplexity.main(["--tokens", tokens[0], "--cpu"])


def test_module_imports_no_jax():
    source = Path(perplexity.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "onnx_quantize_tpu"}, names
    assert "onnx_quantize_tpu_torch" in names and "torch" in names


def test_text_without_transformers_fails_clearly(tmp_path, monkeypatch):
    """``--text`` needs ``transformers`` for its tokenizer (the card's machine
    has none): without it the command line says so."""
    import sys

    model = Gemma3(CFG)
    save_checkpoint(str(tmp_path / "ckpt"), model, model.init(torch.Generator().manual_seed(0)))
    (tmp_path / "t.txt").write_text("some text")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="--text needs the transformers package"):
        perplexity.main(["--checkpoint", str(tmp_path / "ckpt"), "--text",
                         str(tmp_path / "t.txt"), *WINDOW])
