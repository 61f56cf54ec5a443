"""Train step: loss -> grads -> clip -> optimizer, with microbatching.

The PyTorch counterpart of the JAX package's ``train/steps.py``.  The
step ``train_step(state, batch) -> (state, metrics)`` runs the model's
``loss_fn`` (whose attention, with ``cfg.attn_impl="pallas"``, is the
flash-attention kernel), takes the gradients of the fp32 master
parameters with ``torch.autograd.grad``, clips them by global norm and
applies the optimizer **in place**: the returned state holds the same
parameter tensors, updated.  ``microbatches > 1`` splits the batch and
sums the fp32 gradients scaled by ``1 / microbatches``, as the JAX step
does.  The optimizer sees the parameters in the JAX package's layout
(``model.reference_layout``), so its shape rules and its state match
the JAX package's leaf for leaf.

Energy measurement goes through a shared ``pmt.Session``
(:func:`make_measured_train_step`): the step runs inside a session
region fenced by ``torch.cuda.synchronize()`` on the card (nothing to
wait for on the CPU), so an asynchronous step cannot leak its tail into
the next region.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.optim.optimizers import (OptState, OptimizerConfig,
                                          clip_by_global_norm,
                                          make_optimizer, wsd_schedule)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState


def _requires_grad(tree):
    return tree_map(lambda t: t.requires_grad_(True), tree)


def init_train_state(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                     seed: int = 0, device=None) -> TrainState:
    """Random fp32 master parameters from ``seed`` (``model.init_params``)
    and a fresh optimizer state, on the card unless ``device="cpu"``.
    ``repro_torch.bridge.train_state_from_numpy`` carries a JAX state
    across instead."""
    params = _requires_grad(model_mod.init_params(cfg, seed, device))
    init_opt, _ = make_optimizer(opt_cfg)
    return TrainState(params=params,
                      opt=init_opt(model_mod.reference_layout(cfg, params)))


def checkpoint_tree(cfg: ModelConfig, state: TrainState) -> TrainState:
    """The state as the JAX package checkpoints it (``TrainState`` of
    params in the JAX layout and the optimizer state); views."""
    return TrainState(model_mod.reference_layout(cfg, state.params),
                      state.opt)


def from_checkpoint_tree(cfg: ModelConfig, tree: TrainState) -> TrainState:
    """A state restored from :func:`checkpoint_tree`'s layout, ready to
    train."""
    params = model_mod.port_layout(cfg, tree.params)
    return TrainState(_requires_grad(tree_map(
        lambda t: t.detach().contiguous(), params)), tree.opt)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n} "
                             f"microbatches")
    return [{k: x.chunk(n)[i] for k, x in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens", "targets"} (B, S) integer tensors on the
    parameters' device.  ``metrics``: 0-dim tensors ``loss``, ``nll``,
    ``aux_loss``, ``grad_norm`` (before clipping) and ``lr``."""
    loss_f = model_mod.loss_fn(cfg)
    _, update = make_optimizer(opt_cfg)

    def grad_f(params, batch):
        loss, metrics = loss_f(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return ({k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def train_step(state: TrainState, batch):
        if microbatches == 1:
            metrics, grads = grad_f(state.params, batch)
        else:
            grads = metrics = None
            for bi in _split_microbatches(batch, microbatches):
                m, g = grad_f(state.params, bi)
                g = tree_map(lambda a: a.float() * (1.0 / microbatches), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            metrics = {k: v / microbatches for k, v in metrics.items()}

        grads, gnorm = clip_by_global_norm(
            model_mod.reference_layout(cfg, grads), opt_cfg.grad_clip)
        _, opt = update(grads, state.opt,
                        model_mod.reference_layout(cfg, state.params))
        metrics["grad_norm"] = gnorm
        metrics["lr"] = wsd_schedule(opt_cfg, opt.step)
        return TrainState(params=state.params, opt=opt), metrics

    return train_step


def make_measured_train_step(step_fn: Callable, monitor,
                             tokens_per_step: Optional[int] = None,
                             flops_per_step: Optional[float] = None,
                             fence_key: str = "loss",
                             blocking: bool = False):
    """Wrap a train step with fenced PMT measurement.

    ``monitor`` is a :class:`repro_torch.core.PowerMonitor`; its session
    region brackets the step, and when ``metrics[fence_key]`` lies on
    the card the region waits for the card (``torch.cuda.synchronize``)
    before it exits, so the step's queued kernels count in its own
    region.  Measurement is non-blocking by default, as in the JAX
    package: ``box.records`` materialises the step's ``StepEnergy`` rows
    on first access.  Returns ``measured(state, batch, step) -> (state,
    metrics, box)``; ``blocking=True`` resolves every step eagerly.
    """

    def measured(state, batch, step: int):
        with monitor.measure_step(step, flops=flops_per_step,
                                  tokens=tokens_per_step,
                                  blocking=blocking) as box:
            state, metrics = step_fn(state, batch)
            fence = metrics[fence_key]
            if fence.is_cuda:
                torch.cuda.synchronize(fence.device)
        return state, metrics, box

    return measured
