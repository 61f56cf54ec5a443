"""Carry a JAX parameter tree into the port, and back.

``params_from_numpy`` takes the JAX package's parameter tree with numpy
leaves — ``jax.device_get(init_params(PRNGKey(s), cfg)[0])`` — and
returns the port's tree of tensors: the same names, the same values.
The JAX package stacks its units on a leading layer axis only when
there is more than one; the port always stacks, so a single unit gains
the axis here.  Tied embeddings need nothing: both trees keep the one
``embed/embedding`` matrix.  This module imports no JAX: the caller
hands it numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import unit_layout


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16, 2 bytes wide
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _convert(tree, fn):
    if isinstance(tree, dict):
        return {k: _convert(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The port's parameter tree from a JAX tree of numpy arrays, on the
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    out = _convert(tree, lambda x: _to_tensor(x, dev))
    if unit_layout(cfg).n_units == 1:
        out["units"] = _convert(out["units"], lambda t: t[None])
    return out


def params_to_numpy(params, cfg: ModelConfig):
    """The JAX-layout tree of numpy arrays (bf16 leaves as float32)."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = _convert(params, leaf)
    if unit_layout(cfg).n_units == 1:
        out["units"] = _convert(out["units"], lambda a: a[0])
    return out
