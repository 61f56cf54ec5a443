"""Plain PyTorch versions of GRIDDER and DEGRIDDER.

The same functions as the JAX package's ``gridder_ref`` and
``degridder_ref``: the phase ``TWO_PI * (l*u + m*v)`` in float32, with
``TWO_PI`` rounded to float32 as the JAX expression rounds it, the
phasor ``exp(i * phase)`` in complex64, and its sums over visibilities
(gridder) or, conjugated, over pixels (degridder); results come back as
(..., 2) real/imaginary planes in float32.

They run blockwise over subgrids: the whole (S, P, V) phase tensor of
the Fig. 2 size (S = 1024, P = 1024, V = 2048) would take 8.6 GB per
float32 plane, so each block holds at most ``BLOCK_TERMS`` terms.
"""
from __future__ import annotations

import math

import torch

BLOCK_TERMS = 1 << 25        # (subgrid, pixel, visibility) terms per block


def _phasor(lm: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """lm (P, 2), uv (k, V, 2) -> exp(i 2 pi (l u + m v)), (k, P, V)
    complex64."""
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32,
                          device=lm.device)
    phase = torch.einsum("pc,svc->spv", lm.float(), uv.float()) * two_pi
    return torch.complex(torch.cos(phase), torch.sin(phase))


def _blocks(s: int, p: int, v: int):
    step = max(1, BLOCK_TERMS // max(1, p * v))
    return [slice(i, min(i + step, s)) for i in range(0, s, step)]


def _planes(z: torch.Tensor) -> torch.Tensor:
    return torch.stack([z.real, z.imag], dim=-1).float()


def gridder_ref(lm: torch.Tensor, uv: torch.Tensor,
                vis: torch.Tensor) -> torch.Tensor:
    """lm (P, 2), uv (S, V, 2), vis (S, V, 2) -> subgrids (S, P, 2)."""
    s, v, _ = uv.shape
    p = lm.shape[0]
    out = torch.empty((s, p, 2), dtype=torch.float32, device=lm.device)
    for blk in _blocks(s, p, v):
        ph = _phasor(lm, uv[blk])
        x = torch.complex(vis[blk, :, 0].float(), vis[blk, :, 1].float())
        out[blk] = _planes(torch.einsum("spv,sv->sp", ph, x))
    return out


def degridder_ref(lm: torch.Tensor, uv: torch.Tensor,
                  subgrids: torch.Tensor) -> torch.Tensor:
    """lm (P, 2), uv (S, V, 2), subgrids (S, P, 2) -> visibilities
    (S, V, 2)."""
    s, v, _ = uv.shape
    p = lm.shape[0]
    out = torch.empty((s, v, 2), dtype=torch.float32, device=lm.device)
    for blk in _blocks(s, p, v):
        ph = _phasor(lm, uv[blk])
        g = torch.complex(subgrids[blk, :, 0].float(),
                          subgrids[blk, :, 1].float())
        out[blk] = _planes(torch.einsum("spv,sp->sv", ph.conj(), g))
    return out
