"""The flash-attention op the models call.

``flash_attention`` takes the framework's (B, S, H, hd) layout, flattens
to the kernel's (B·H, S, hd) as the JAX package's ops do, and runs a
``torch.autograd.Function``:

  * forward — the CUDA kernel for tensors on the card (no fallback), the
    plain version for tensors on the CPU;
  * backward — the VJP of the plain oracle, recomputed under
    ``torch.enable_grad()`` from the saved q, k, v.  This is the JAX
    package's ``_fa_bwd``, which takes ``jax.vjp`` of
    ``flash_attention_ref``: there the backward is XLA code, not a
    Pallas kernel, so its port is plain PyTorch on either device.  It
    materialises fp32 (B·H, Sq, Skv) scores and probabilities.

Under ``torch.utils.checkpoint`` the forward runs again in the backward
pass, so a checkpointed layer launches the kernel twice per step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        if on_card(q, k, v):
            return flash_attention_cuda(q, k, v, **kw)
        return flash_attention_ref(q, k, v, **kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_ref(q, k, v, **ctx.kw)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: float = 1.0) -> torch.Tensor:
    """q: (B, Sq, H, hd), k/v: (B, Skv, KVH, hd) -> (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    qf = q.permute(0, 2, 1, 3).reshape(b * h, sq, hd)
    kf = k.permute(0, 2, 1, 3).reshape(b * kvh, skv, hd)
    vf = v.permute(0, 2, 1, 3).reshape(b * kvh, skv, hd)
    of = _FlashAttention.apply(qf.contiguous(), kf.contiguous(),
                               vf.contiguous(), causal, window, softcap,
                               scale)
    return of.reshape(b, h, sq, hd).permute(0, 2, 1, 3)
