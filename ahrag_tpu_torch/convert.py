"""Carry state across from ``ahrag_tpu`` as numpy arrays.

The JAX package's ``GraphTensors`` leaves, hashed-encoder projection and IDF,
and ``SearchWeights`` are handed over as numpy arrays (``np.asarray`` of each
JAX array), so that both packages compute on identical state. bf16 arrays
arrive as numpy's ``bfloat16`` extension type; their bits are reinterpreted,
never rounded again.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Dict

import numpy as np
import torch

from ahrag_tpu_torch.device import resolve_device
from ahrag_tpu_torch.graph.search import SearchWeights
from ahrag_tpu_torch.graph.tensors import GraphTensors

_STATIC = ("n_nodes", "n_edges", "mask_trivial")


def tensor_from_numpy(x, device: torch.device) -> torch.Tensor:
    a = np.array(x, order="C")   # a writable copy: JAX exports read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def graph_tensors_from_numpy(leaves: Dict[str, object], device=None) -> GraphTensors:
    """``GraphTensors`` from the JAX ``GraphTensors`` fields as numpy arrays
    (None for absent optional tables) plus ``n_nodes``, ``n_edges`` and
    ``mask_trivial``."""
    dev = resolve_device(device)
    kw = {}
    for f in fields(GraphTensors):
        v = leaves.get(f.name)
        if f.name in _STATIC:
            kw[f.name] = type(f.default)(v)
        else:
            kw[f.name] = None if v is None else tensor_from_numpy(v, dev)
    return GraphTensors(**kw)


def projection_from_numpy(proj, idf, device=None):
    """(projection [buckets, dim], idf [buckets]) as float32 device tensors."""
    dev = resolve_device(device)
    return (tensor_from_numpy(np.asarray(proj, np.float32), dev),
            tensor_from_numpy(np.asarray(idf, np.float32), dev))


def search_weights_from_numpy(w: Dict[str, object], device=None) -> SearchWeights:
    """``SearchWeights`` from the JAX ``SearchWeights`` fields as numpy."""
    dev = resolve_device(device)
    return SearchWeights(**{f.name: tensor_from_numpy(np.asarray(w[f.name]), dev)
                            for f in fields(SearchWeights)})


def policy_params_from_numpy(tree: Dict[str, Dict[str, object]]) -> Dict[str, torch.Tensor]:
    """A flax Dense param tree (``{layer: {"kernel": [in, out], "bias":
    [out]}}``, numpy or JAX arrays) as the ``state_dict`` of the port's
    ``MLPPolicy`` or ``ActorCritic`` (``{layer}.weight [out, in]``,
    ``{layer}.bias``), on the CPU; ``load_state_dict`` moves it."""
    out = {}
    for name, layer in tree.items():
        out[f"{name}.weight"] = torch.from_numpy(
            np.array(layer["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return out


def flax_params_from_numpy(tree: Dict[str, object], prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax parameter tree (numpy or JAX arrays; with or without its
    top-level ``"params"`` key) as the ``state_dict`` of the port's
    counterpart module (``models/flax_layers.py`` keeps flax's names and
    shapes): each leaf under its dotted path, float32, on the CPU."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out.update(flax_params_from_numpy(sub, f"{prefix}{name}."))
        else:
            out[prefix + name] = torch.from_numpy(np.array(sub, np.float32))
    return out
