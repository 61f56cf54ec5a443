"""Wrapper of the CUDA tiled GEMM (``csrc/gemm.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0


def gemm_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (M, K), b: (K, N), contiguous, both float32 or both bfloat16,
    on the card.  Returns a new float32 (M, N)."""
    global launches
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("gemm_cuda takes tensors on the card")
    code = build.dtype_code(a.dtype)
    if b.dtype != a.dtype:
        raise ValueError(f"a is {a.dtype}, b is {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, k) >= 2 ** 31 or m > 65535 * 128:
        raise ValueError(f"shape {(m, k, n)} is beyond the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    err = build.library().pmt_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, code,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "gemm")
    launches += 1
    return out
