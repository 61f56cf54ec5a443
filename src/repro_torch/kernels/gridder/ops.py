"""The GRIDDER and DEGRIDDER ops: the CUDA kernels for tensors on the
card, the plain versions for tensors on the CPU.

They drop the JAX ops' ``block_v`` (the TPU's visibility block; the CUDA
kernels stage their own chunks) and ``interpret`` (Pallas's CPU mode),
which mean nothing on the card.  Unlike the TPU kernels they take any P,
V and S, not only multiples of 128.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.gridder.kernel import degridder_cuda, gridder_cuda
from repro_torch.kernels.gridder.ref import degridder_ref, gridder_ref


def gridder(lm: torch.Tensor, uv: torch.Tensor,
            vis: torch.Tensor) -> torch.Tensor:
    """lm (P, 2), uv (S, V, 2), vis (S, V, 2) float32 -> subgrids
    (S, P, 2): ``sum_v vis * exp(2 pi i (l u + m v))`` per pixel."""
    if not on_card(lm, uv, vis):
        return gridder_ref(lm, uv, vis)
    return gridder_cuda(lm.contiguous(), uv.contiguous(), vis.contiguous())


def degridder(lm: torch.Tensor, uv: torch.Tensor,
              subgrids: torch.Tensor) -> torch.Tensor:
    """lm (P, 2), uv (S, V, 2), subgrids (S, P, 2) float32 -> visibilities
    (S, V, 2): the adjoint, ``sum_p sub * exp(-2 pi i (l u + m v))``."""
    if not on_card(lm, uv, subgrids):
        return degridder_ref(lm, uv, subgrids)
    return degridder_cuda(lm.contiguous(), uv.contiguous(),
                          subgrids.contiguous())
