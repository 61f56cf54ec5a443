"""Wrapper of the CUDA STREAM triad (``csrc/stream.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0


def stream_triad_cuda(a: torch.Tensor, b: torch.Tensor,
                      scalar: float) -> torch.Tensor:
    """a, b: contiguous, same shape and dtype (float32 or bfloat16), on
    the card.  Returns a new tensor ``a + scalar * b``."""
    global launches
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("stream_triad_cuda takes tensors on the card")
    code = build.dtype_code(a.dtype)
    if b.dtype != a.dtype or b.shape != a.shape:
        raise ValueError(f"a and b must share shape and dtype, got "
                         f"{tuple(a.shape)} {a.dtype} and "
                         f"{tuple(b.shape)} {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    out = torch.empty_like(a)
    err = build.library().pmt_stream_triad(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
        float(scalar), code, torch.cuda.current_stream().cuda_stream)
    build.check(err, "stream_triad")
    launches += 1
    return out
