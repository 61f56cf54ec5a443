"""Wrapper of the CUDA Jacobi-2D sweep (``csrc/jacobi2d.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0

ROWS = 4                  # rows a thread walks down (csrc/jacobi2d.cu ROWS)
BLOCK_COLUMNS = 128 * 4   # columns a block covers on the 16-byte path


def jacobi2d_cuda(x: torch.Tensor) -> torch.Tensor:
    """x: contiguous (H, W) float32 on the card, at any 4-byte alignment.
    Returns a new tensor; x is not written."""
    global launches
    if not x.is_cuda:
        raise ValueError("jacobi2d_cuda takes a tensor on the card")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (H, W) float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    h, w = x.shape
    # gridDim.y is at most 65535 strips; the first column of the last
    # block's threads must fit an int
    if h > 65535 * ROWS or w >= 2 ** 31 - BLOCK_COLUMNS:
        raise ValueError(f"shape {(h, w)} is beyond the kernel's grid")
    out = torch.empty_like(x)
    err = build.library().pmt_jacobi2d(
        x.data_ptr(), out.data_ptr(), h, w,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "jacobi2d")
    launches += 1
    return out
