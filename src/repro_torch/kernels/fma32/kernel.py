"""Wrapper of the CUDA FMA32 chain (``csrc/fma32.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0


def fma32_cuda(x: torch.Tensor, iters: int) -> torch.Tensor:
    """x: contiguous float32 on the card, any shape; iters >= 0.
    Returns a new tensor of x's shape."""
    global launches
    if not x.is_cuda:
        raise ValueError("fma32_cuda takes a tensor on the card")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 tensor, got "
                         f"{x.dtype}")
    if iters < 0 or iters >= 2 ** 31:
        raise ValueError(f"iters must lie in [0, 2^31), got {iters}")
    out = torch.empty_like(x)
    err = build.library().pmt_fma32(
        x.data_ptr(), out.data_ptr(), x.numel(), iters,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "fma32")
    launches += 1
    return out
