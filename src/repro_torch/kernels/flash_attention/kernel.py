"""Wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0

# Head widths the kernel is compiled for (each thread holds hd / 16
# output columns of its rows).
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: float = 1.0) -> torch.Tensor:
    """q: (BH, Sq, hd), k/v: (BKVH, Skv, hd), BH a multiple of BKVH, all
    float32 or all bfloat16, contiguous, on the card.  Any Sq and Skv;
    hd one of ``HEAD_DIMS``.  Returns (BH, Sq, hd) in q.dtype.  A query
    row that can attend no key (only where Sq >= Skv + window) comes
    out as zeros, where the plain oracle averages every key."""
    global launches
    ts = (q, k, v)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_cuda takes tensors on the card")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k and v must be contiguous")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"need q (BH, Sq, hd) and k, v (BKVH, Skv, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, sq, hd = q.shape
    bkvh, skv, _ = k.shape
    if k.shape[2] != hd:
        raise ValueError(f"k/v head width {k.shape[2]} is not q's {hd}")
    if bkvh == 0 or bh % bkvh:
        raise ValueError(f"BH={bh} is not a multiple of BKVH={bkvh}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not supported; the kernel "
                         f"takes {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k and v must share a dtype")
    if window is not None and window <= 0:
        raise ValueError("window must be > 0")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be > 0")
    if max(sq, skv) >= 2 ** 31 or bh > 65535:
        raise ValueError(f"shape {tuple(q.shape)} is beyond the kernel's "
                         f"grid")
    code = build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    err = build.library().pmt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bkvh,
        sq, skv, hd, float(scale), int(causal), int(window or 0),
        float(softcap or 0.0), code, torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    launches += 1
    return out
