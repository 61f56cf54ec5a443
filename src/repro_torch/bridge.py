"""Carry a JAX parameter tree, or a JAX train state, into the port, and
back.

``params_from_numpy`` takes the JAX package's parameter tree with numpy
leaves — ``jax.device_get(init_params(PRNGKey(s), cfg)[0])`` — and
returns the port's tree of tensors: the same names, the same values.
The JAX package stacks its units on a leading layer axis only when
there is more than one; the port always stacks, so a single unit gains
the axis here.  Tied embeddings need nothing: both trees keep the one
``embed/embedding`` matrix; MLA's weights and deepseek-v3's ``mtp``
subtree (an unstacked block) carry over leaf for leaf.  This module imports no JAX: the caller
hands it numpy arrays.

``train_state_from_numpy`` does the same for a JAX ``TrainState``
(``jax.device_get(state)``): parameters as above, the optimizer's step
and moments as they are (the port's optimizer state already has the
JAX layout, see ``models.model.reference_layout``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import port_layout, reference_layout
from repro_torch.optim.optimizers import OptState
from repro_torch.train.steps import TrainState
from repro_torch.tree import tree_map


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16, 2 bytes wide
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host, bf16 widened to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The port's parameter tree from a JAX tree of numpy arrays, on the
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    return port_layout(cfg, tree_map(lambda x: _to_tensor(x, dev), tree))


def params_to_numpy(params, cfg: ModelConfig):
    """The JAX-layout tree of numpy arrays (bf16 leaves as float32)."""
    return tree_map(to_numpy, reference_layout(cfg, params))


def train_state_from_numpy(state, cfg: ModelConfig, device=None
                           ) -> TrainState:
    """The port's ``TrainState`` from a JAX one with numpy leaves (any
    object with ``params`` and ``opt.step`` / ``opt.inner``), on the
    card unless ``device="cpu"``; the parameters require grad."""
    dev = resolve_device(device)
    params = params_from_numpy(state.params, cfg, dev)
    inner = tree_map(lambda x: _to_tensor(x, dev), state.opt.inner)
    return TrainState(
        params=tree_map(lambda t: t.requires_grad_(True), params),
        opt=OptState(step=_to_tensor(state.opt.step, dev), inner=inner))
