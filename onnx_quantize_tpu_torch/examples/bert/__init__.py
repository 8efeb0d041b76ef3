"""BERT-classifier quantization example (the synthetic SST-2 accuracy table)."""
