"""BERT-classifier quantization: the synthetic SST-2 accuracy table.

Port of the repository's ``examples/bert/bert_sst2.py``: train a BERT-style
encoder deterministically on the synthetic sentiment task
(``models/bert.py``), quantize it under five configs, and print the accuracy
of the float model and of each quantized one.

Usage:
    python -m onnx_quantize_tpu_torch.examples.bert.bert_sst2 [--steps 400] [--eval 512] [--cpu]
"""

from __future__ import annotations

import argparse

import onnx_quantize_tpu_torch as oqt
from onnx_quantize_tpu_torch.examples import add_cpu_flag, device_of
from onnx_quantize_tpu_torch.models.bert import (
    BertClassifier,
    BertConfig,
    accuracy,
    synthetic_sst2,
    train_classifier,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--eval", type=int, default=512)
    add_cpu_flag(parser)
    return parser.parse_args(argv)


def config() -> BertConfig:
    return BertConfig()


def qconfigs(calib: dict) -> list[tuple[str, oqt.QConfig]]:
    """The table's five configs, by name, in its order."""
    return [
        ("uint8 / per-channel", oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint8", symmetric=False, group_size=-1))),
        ("uint4 / group-128 RTN", oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", strategy="group", group_size=128))),
        ("uint4 / group-128 HQQ", oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint4", strategy="group", group_size=128,
                                    algorithm=oqt.HqqConfig(early_stop=False)))),
        ("int8 / per-channel AWQ", oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="int8", group_size=-1),
            preprocessors=[oqt.AwqConfig()], calibration_data=calib)),
        ("W8A8 static + SmoothQuant", oqt.QConfig(
            weights=oqt.QWeightArgs(dtype="uint8", symmetric=False, group_size=-1),
            input_activations=oqt.QActivationArgs(dtype="uint8", is_static=True),
            preprocessors=[oqt.SmoothQuantConfig(alpha=0.5)],
            calibration_data=calib)),
    ]


def run(model: BertClassifier, params: dict, n_eval: int) -> list[tuple[str, float]]:
    """The table's rows, (name, accuracy): the float model's, then each
    config's, on ``n_eval`` evaluation sentences; printed."""
    cfg = model.cfg
    eval_ids, eval_mask, eval_labels = synthetic_sst2(n_eval, cfg, seed=99)
    calib_ids, calib_mask, _ = synthetic_sst2(128, cfg, seed=41)
    calib = {"input_ids": calib_ids, "attention_mask": calib_mask}

    def acc(p):
        return accuracy(model, p, eval_ids, eval_mask, eval_labels)

    rows = [("fp32", acc(params))]
    for name, qconfig in qconfigs(calib):
        qparams, _ = oqt.quantize(model, params, qconfig)
        rows.append((name, acc(qparams)))

    width = max(len(n) for n, _ in rows)
    print(f"\n{'config'.ljust(width)}  accuracy")
    for name, value in rows:
        print(f"{name.ljust(width)}  {value:.4f}")
    return rows


def main(argv=None) -> list[tuple[str, float]]:
    """Returns the table's rows."""
    args = parse_args(argv)
    model = BertClassifier(config())
    print(f"training ({args.steps} steps, deterministic) ...")
    params = train_classifier(model, steps=args.steps, device=device_of(args))
    return run(model, params, args.eval)


if __name__ == "__main__":
    main()
