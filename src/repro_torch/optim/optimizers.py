"""Optimizers: AdamW (fp32 moments) and Adafactor (factored second
moment), the PyTorch counterparts of the JAX package's
``optim/optimizers.py``.

Trees are dicts of tensors.  The optimizer state mirrors the parameter
tree; ``update`` takes the gradients as a tree of the same shape.  The
operations and their order are the JAX package's: bias correction as
``m / bc1``, ``eps`` outside the square root, weight decay on tensors of
two or more dimensions only, Adafactor's factored rule and its RMS-1
update clip.  Unlike the JAX functions, ``update`` writes the new
parameters and moments **in place** (under ``torch.no_grad()``), so a
step holds new values for one leaf at a time rather than a second copy
of the model; it returns the same parameter tree and a new ``OptState``
holding the updated moments.

The state's step counter is a 0-dim int32 tensor on the parameters'
device, so the schedule runs there too, with no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128


@dataclasses.dataclass
class OptState:
    step: torch.Tensor               # 0-dim int32
    inner: Any                       # optimizer-specific tree


# -- schedule -----------------------------------------------------------------

def wsd_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup-stable-decay (linear warmup, cosine decay to min_lr_frac),
    in fp32 on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * decay


# -- grad clip ------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _set(p: torch.Tensor, new32: torch.Tensor) -> None:
    p.copy_(new32.to(p.dtype))


# -- AdamW ----------------------------------------------------------------------

def adamw(cfg: OptimizerConfig):
    def init(params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        dev = tree_leaves(params)[0].device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        inner={"m": tree_map(zeros, params),
                               "v": tree_map(zeros, params)})

    @torch.no_grad()
    def update(grads, state: OptState, params) -> Tuple[Any, OptState]:
        step = state.step + 1
        lr = wsd_schedule(cfg, step)
        t = step.float()
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t

        def upd(g, m, v, p):
            g32 = g.float()
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g32))
            mh, vh = m / bc1, v / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            if p.dim() >= 2:   # decay matrices only (standard practice)
                delta = delta + cfg.weight_decay * p.float()
            _set(p, p.float() - lr * delta)

        tree_map(upd, grads, state.inner["m"], state.inner["v"], params)
        return params, OptState(step=step, inner=state.inner)

    return init, update


# -- Adafactor --------------------------------------------------------------------

def _factored(p: torch.Tensor, min_dim: int) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= min_dim \
        and p.shape[-2] >= min_dim


def adafactor(cfg: OptimizerConfig):
    """Adafactor with momentum-free updates and factored second moments."""

    def init(params) -> OptState:
        def stat(p):
            def z(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)

            if _factored(p, cfg.factored_min_dim):
                return {"vr": z(p.shape[:-1]),
                        "vc": z((*p.shape[:-2], p.shape[-1]))}
            return {"v": z(p.shape)}

        dev = tree_leaves(params)[0].device
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                        inner=tree_map(stat, params))

    @torch.no_grad()
    def update(grads, state: OptState, params) -> Tuple[Any, OptState]:
        step = state.step + 1
        lr = wsd_schedule(cfg, step)
        t = step.float()
        beta = 1.0 - t ** (-cfg.decay_rate)

        def upd(g, s, p):
            g32 = torch.square(g.float()) + 1e-30
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                vr.copy_(beta * vr + (1 - beta) * g32.mean(-1))
                vc.copy_(beta * vc + (1 - beta) * g32.mean(-2))
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                  min=1e-30))
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g32)
                denom = torch.sqrt(s["v"])
            delta = g.float() / torch.clamp(denom, min=1e-30)
            # update clipping (Adafactor's RMS-1 rule)
            rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
            delta = delta / torch.clamp(rms, min=1.0)
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.float()
            _set(p, p.float() - lr * delta)

        # the stats mirror params down to each leaf's stat dict
        tree_map(upd, grads, state.inner, params)
        return params, OptState(step=step, inner=state.inner)

    return init, update


# -- factory ----------------------------------------------------------------------

def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return adamw(cfg)
    if cfg.name == "adafactor":
        return adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
