from onnx_quantize_tpu_torch.utils.tree import copy_tree, tree_get, tree_map, untie_params

__all__ = ["tree_get", "copy_tree", "tree_map", "untie_params"]
