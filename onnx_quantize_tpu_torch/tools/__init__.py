from onnx_quantize_tpu_torch.tools.perplexity import perplexity_eval, perplexity_from_tokens

__all__ = ["perplexity_eval", "perplexity_from_tokens"]
