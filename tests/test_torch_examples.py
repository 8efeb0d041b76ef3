"""The port's examples (``onnx_quantize_tpu_torch/examples``) against the JAX
package's (``examples/``), on the CPU.

Each JAX example runs unedited, loaded from its file by path with
``sys.argv`` patched; beside it runs the port's example with ``--cpu``.
Both get the same float weights: one Hugging Face safetensors directory,
written here at the example's tiny config, passed to both as
``--hf-weights``. Where an example hard-codes a full-width config
(``GEMMA3_270M``), that module constant is patched to the same tiny config on
both sides.

Checkpoints: both are loaded by the port's ``load_checkpoint(device="cpu")``;
the configs equal, integer leaves bit-equal, float leaves within 1e-6
relative, metas equal. GPTQ and AWQ get the bars of ``test_torch_gptq.py``
and ``test_torch_awq.py``: at most 0.5% of each site's codes and zero
points differ (GPTQ's Cholesky factors and AWQ's captured activations are
float32 sums in another order, and a code at a rounding tie flips), the
scales and AWQ's prescales within 1e-4 relative. The prescales come from
activations captured through a two-layer forward (1.4e-5 relative apart
here); a neighbouring point of AWQ's 20-point grid moves a prescale by
percents, so the bar holds the two searches to the same grid point.
``serving``: JAX's ``build(tiny=True)`` tree carried across with
``interop.from_jax_params``; every greedy request equals JAX's on the
example's workload, every request ends within its budget. ``bert_sst2``:
JAX's trained params (``train_classifier(steps=20)``) carried across; the
port's table has JAX's six rows in order, each accuracy within one sentence
(the tie ``test_torch_bert.py`` allows).
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.models.gemma3 import Gemma3Config as JGemma3Config
from onnx_quantize_tpu_torch.checkpoint import load_checkpoint
from onnx_quantize_tpu_torch.examples import llama_rotate_w4, llama_rtn, moe_rtn, serving
from onnx_quantize_tpu_torch.examples.bert import bert_sst2
from onnx_quantize_tpu_torch.examples.gemma3 import gemma3_awq, gemma3_rtn
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.models.bert import BertClassifier, BertConfig
from onnx_quantize_tpu_torch.models.gemma3 import Gemma3Config
from onnx_quantize_tpu_torch.models.llama import tiny_llama_config
from onnx_quantize_tpu_torch.models.moe import tiny_moe_config
from onnx_quantize_tpu_torch.nn.qtensor import QTensor

safetensors_numpy = pytest.importorskip("safetensors.numpy")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# The Gemma-3 examples' tiny config: widths that are multiples of 128, so
# their group-128 configs quantize in whole groups (down_proj: two).
GEMMA3_TINY = dict(hidden_size=128, intermediate_size=256, num_heads=2, num_kv_heads=1,
                   head_dim=64, vocab_size=512)
CODE_SHARE = 0.005  # tests/test_torch_gptq.py: differing codes allowed end to end
RTOL = 1e-6
SEARCHED_RTOL = 1e-4  # GPTQ's and AWQ's scales, AWQ's prescales


def jax_example(relpath: str):
    """A JAX example module, loaded from its file."""
    path = REPO / "examples" / relpath
    spec = importlib.util.spec_from_file_location(f"jax_example_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax(module, monkeypatch, argv: list[str]):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    return module.main()


def write_hf(directory: Path, cfg, family: str, seed: int = 0) -> str:
    """Float32 tensors under HF names, projections (out, in), the head tied."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.hidden_size, cfg.head_dim

    def t(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    def glu(prefix, inter):
        return {f"{prefix}.gate_proj.weight": t(inter, d), f"{prefix}.up_proj.weight": t(inter, d),
                f"{prefix}.down_proj.weight": t(d, inter)}

    tensors = {"model.embed_tokens.weight": t(cfg.vocab_size, d), "model.norm.weight": t(d)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        tensors.update({
            f"{p}.self_attn.q_proj.weight": t(cfg.num_heads * hd, d),
            f"{p}.self_attn.k_proj.weight": t(cfg.num_kv_heads * hd, d),
            f"{p}.self_attn.v_proj.weight": t(cfg.num_kv_heads * hd, d),
            f"{p}.self_attn.o_proj.weight": t(d, cfg.num_heads * hd),
            f"{p}.input_layernorm.weight": t(d),
            f"{p}.post_attention_layernorm.weight": t(d),
        })
        if family == "gemma3":
            tensors.update({
                f"{p}.self_attn.q_norm.weight": t(hd), f"{p}.self_attn.k_norm.weight": t(hd),
                f"{p}.pre_feedforward_layernorm.weight": t(d),
                f"{p}.post_feedforward_layernorm.weight": t(d),
                **glu(f"{p}.mlp", cfg.intermediate_size)})
        elif family == "llama":
            tensors.update(glu(f"{p}.mlp", cfg.intermediate_size))
        else:  # Qwen-MoE names, no shared expert
            tensors[f"{p}.mlp.gate.weight"] = t(cfg.num_experts, d)
            for e in range(cfg.num_experts):
                tensors.update(glu(f"{p}.mlp.experts.{e}", cfg.moe_intermediate_size))
    directory.mkdir(parents=True, exist_ok=True)
    safetensors_numpy.save_file(tensors, str(directory / "model.safetensors"))
    return str(directory)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def assert_checkpoints_match(ours: str, theirs: str, searched: bool = False) -> int:
    """The two checkpoints' configs, structure, metas and leaves (see the
    module docstring); ``searched``: the GPTQ/AWQ bars. Returns the number of
    QTensor leaves."""
    model, params = load_checkpoint(ours, device="cpu")
    jmodel, jparams = load_checkpoint(theirs, device="cpu")
    assert model.cfg == jmodel.cfg
    got, want = dict(leaves(params)), dict(leaves(jparams))
    assert set(got) == set(want)
    sites = 0
    for path, a in got.items():
        b = want[path]
        if isinstance(b, QTensor):
            sites += 1
            assert isinstance(a, QTensor) and a.meta == b.meta, path
            pairs = [(f, getattr(a, f), getattr(b, f)) for f in ("data", "scale", "zero_point")]
        else:
            pairs = [("", a, b)]
        for field, x, y in pairs:
            x, y = x.numpy(), y.numpy()
            assert x.dtype == y.dtype and x.shape == y.shape, (path, field)
            if searched and field in ("data", "zero_point"):
                assert np.mean(x != y) <= CODE_SHARE, (path, field)
            elif np.issubdtype(x.dtype, np.integer):
                assert x.tobytes() == y.tobytes(), (path, field)
            else:
                rtol = SEARCHED_RTOL if searched and (field or path[-1] == "prescale") else RTOL
                np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=str((path, field)))
    return sites


@pytest.mark.parametrize("name", ["gemma3_rtn", "gemma3_awq"])
def test_gemma3_example_checkpoint_equals_jax(tmp_path, monkeypatch, name):
    jmod = jax_example(f"gemma3/{name}.py")
    pmod = {"gemma3_rtn": gemma3_rtn, "gemma3_awq": gemma3_awq}[name]
    monkeypatch.setattr(jmod, "GEMMA3_270M", JGemma3Config.tiny(**GEMMA3_TINY))
    monkeypatch.setattr(pmod, "GEMMA3_270M", Gemma3Config.tiny(**GEMMA3_TINY))
    hf = write_hf(tmp_path / "hf", pmod.config(), "gemma3")
    run_jax(jmod, monkeypatch, ["--output", str(tmp_path / "jax"), "--hf-weights", hf])
    pmod.main(["--output", str(tmp_path / "port"), "--hf-weights", hf, "--cpu"])
    sites = assert_checkpoints_match(str(tmp_path / "port"), str(tmp_path / "jax"),
                                     searched=name == "gemma3_awq")
    assert sites == 7 * pmod.config().num_layers  # the lm_head stays float


# name -> (the port's module, the JAX example's file, its extra flags, HF family)
CHECKPOINT_EXAMPLES = {
    "llama_rtn": (llama_rtn, "llama_rtn.py", [], "llama"),
    "llama_rotate_w4": (llama_rotate_w4, "llama_rotate_w4.py", [], "llama"),
    "llama_rotate_w4_gptq": (llama_rotate_w4, "llama_rotate_w4.py", ["--gptq"], "llama"),
    "moe_rtn": (moe_rtn, "moe_rtn.py", [], "moe"),
}


@pytest.mark.parametrize("name", list(CHECKPOINT_EXAMPLES))
def test_tiny_example_checkpoint_equals_jax(tmp_path, monkeypatch, name):
    pmod, jfile, flags, family = CHECKPOINT_EXAMPLES[name]
    cfg = pmod.config(tiny=True)
    hf = write_hf(tmp_path / "hf", cfg, family)
    common = ["--tiny", "--hf-weights", hf, *flags]
    run_jax(jax_example(jfile), monkeypatch, ["--output", str(tmp_path / "jax"), *common])
    pmod.main(["--output", str(tmp_path / "port"), *common, "--cpu"])
    sites = assert_checkpoints_match(str(tmp_path / "port"), str(tmp_path / "jax"),
                                     searched="--gptq" in flags)
    per_layer = 4 + (3 * cfg.num_experts if cfg.num_experts else 3)
    assert sites == per_layer * cfg.num_layers  # router and lm_head stay float


def test_example_configs_are_the_published_ones():
    assert tiny_llama_config() == llama_rtn.config(tiny=True) == llama_rotate_w4.config(True)
    assert tiny_moe_config(moe_intermediate_size=128) == moe_rtn.config(tiny=True)
    assert llama_rtn.config(False).hidden_size == 2048 and moe_rtn.config(False).num_experts == 60
    assert gemma3_rtn.config() == gemma3_awq.config() == Gemma3Config()
    assert serving.config(False).dtype == "bfloat16" and serving.config(False).num_layers == 18


def test_serving_example_greedy_streams_equal_jax(monkeypatch):
    jmod = jax_example("serving.py")
    built, finished = {}, []

    def build(tiny):
        built["tree"] = build_jax(tiny)
        return built["tree"]

    class Capturing(jmod.ContinuousBatchingScheduler):
        def run(self):
            finished.extend(super().run())
            return finished

    build_jax = jmod.build
    monkeypatch.setattr(jmod, "build", build)
    monkeypatch.setattr(jmod, "ContinuousBatchingScheduler", Capturing)
    run_jax(jmod, monkeypatch, ["--tiny"])
    args = serving.parse_args(["--tiny", "--cpu"])
    jmodel, jparams = built["tree"]
    model = serving.Gemma3(serving.config(tiny=True))
    ours, _ = serving.run(model, from_jax_params(jparams, device="cpu"), args)
    reqs = serving.workload(model.cfg.vocab_size, args.requests)
    assert len(ours) == len(finished) == len(reqs) == 32
    got = {r.request_id: r for r in ours}
    want = {r.request_id: r for r in finished}
    greedy = 0
    for i, (prompt, kw) in enumerate(reqs):
        r = got[i]
        assert r.prompt == prompt == list(want[i].prompt)
        ended = kw["eos_token_id"] is not None and r.output[-1] == kw["eos_token_id"]
        assert len(r.output) == kw["max_new_tokens"] or (
            ended and len(r.output) < kw["max_new_tokens"]), i
        assert all(0 <= t < model.cfg.vocab_size for t in r.output)
        if i % 3 == 0:
            assert r.output == list(want[i].output), i
            greedy += 1
    assert greedy == 11


def test_bert_example_table_equals_jax(monkeypatch, capsys):
    jmod = jax_example("bert/bert_sst2.py")
    trained = {}

    def train(model, steps):
        trained["params"] = train_jax(model, steps=steps)
        return trained["params"]

    train_jax = jmod.train_classifier
    monkeypatch.setattr(jmod, "train_classifier", train)
    run_jax(jmod, monkeypatch, ["--steps", "20", "--eval", "512"])
    lines = capsys.readouterr().out.splitlines()
    table = lines[lines.index(next(l for l in lines if l.startswith("config"))) + 1:]
    want = [(m.group(1).strip(), float(m.group(2)))
            for m in (re.match(r"(.*\S)\s+(\d\.\d{4})$", line) for line in table) if m]
    rows = bert_sst2.run(BertClassifier(BertConfig()),
                         from_jax_params(trained["params"], device="cpu"), 512)
    assert [n for n, _ in rows] == [n for n, _ in want] and len(rows) == 6
    for (name, acc), (_, jacc) in zip(rows, want):
        assert abs(acc - jacc) <= 1 / 512 + 5e-5, name  # one sentence; the print's 4 digits
