"""Param-tree helpers (nested dicts of tensors)."""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)

__all__ = ["tree_get", "copy_tree", "untie_params", "tree_map"]


def tree_get(params: dict, path: tuple[str, ...]) -> dict:
    """Return the nested sub-dict at ``path``."""
    node = params
    for key in path:
        node = node[key]
    return node


def copy_tree(params):
    """Copy the dict structure (leaves shared) so callers can mutate safely."""
    if isinstance(params, dict):
        return {k: copy_tree(v) for k, v in params.items()}
    return params


def tree_map(fn, params):
    """Apply ``fn`` to every non-dict leaf, keeping the dict structure."""
    if isinstance(params, dict):
        return {k: tree_map(fn, v) for k, v in params.items()}
    return fn(params)


def _storage_key(w: torch.Tensor):
    return (w.untyped_storage().data_ptr(), w.storage_offset(), tuple(w.shape),
            tuple(w.stride()))


def untie_params(params: dict, site_paths: list[tuple[str, ...]]) -> dict:
    """Give each quantizable site its own weight copy when leaves are shared.

    Two sites share a weight when their tensors view the same memory with the
    same layout; the second one gets a copy, so each is quantized on its own.
    """
    params = copy_tree(params)
    seen: dict[tuple, tuple[str, ...]] = {}
    for path in site_paths:
        site = tree_get(params, path)
        w = site.get("w")
        if not isinstance(w, torch.Tensor):
            # Already-quantized leaves are skipped by the transform.
            continue
        key = _storage_key(w)
        if key in seen:
            logger.debug("Untying weight shared between %s and %s", seen[key], path)
            site["w"] = w.clone()
        else:
            seen[key] = path
    return params
