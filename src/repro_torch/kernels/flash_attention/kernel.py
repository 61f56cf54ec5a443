"""Wrapper of the CUDA flash-attention forward
(``csrc/flash_attention.cu``): fp32 on the CUDA cores, bf16 on the
tensor cores (wgmma on tiles loaded by TMA)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0

# Head widths the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128)

# Shared-memory budget of one block on the H100 (227 KB usable).
SMEM_LIMIT = 232448
# The bf16 kernel's tiling: K and V tiles of BLOCK_K keys in a ring of
# STAGES; consumer warpgroups of 64 query rows each.  These must match
# ``tc::kBK``, ``tc::kStages`` and ``tc::Tiles`` in flash_attention.cu;
# the library's ``pmt_flash_smem_bytes`` gives the kernel's own size,
# which chip_smoke.py (phase 3f) holds ``smem_bytes`` to on the card.
BLOCK_K = 64
STAGES = 4


def consumers(hd: int) -> int:
    """Consumer warpgroups of a bf16 block at head width ``hd``
    (``tc::Tiles::kConsumers``)."""
    return 3 if hd <= 64 else 2


def smem_bytes(hd: int, bk: int, stages: int) -> int:
    """Dynamic shared memory of one bf16 block: 1 KB of slack to align
    the swizzled tiles, the q rows of its warpgroups, ``stages`` K and V
    tiles of ``bk`` keys, and one mbarrier for q and two per stage."""
    return (1024 + consumers(hd) * 64 * hd * 2 + 2 * stages * bk * hd * 2
            + 8 * (1 + 2 * stages))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: float = 1.0) -> torch.Tensor:
    """q: (BH, Sq, hd), k/v: (BKVH, Skv, hd), BH a multiple of BKVH, all
    float32 or all bfloat16, contiguous, on the card (bf16 ones 16-byte
    aligned, as TMA reads them).  Any Sq and Skv; hd one of
    ``HEAD_DIMS``.  Returns (BH, Sq, hd) in q.dtype.  A query
    row that can attend no key (only where Sq >= Skv + window) comes
    out as zeros, where the plain oracle averages every key."""
    global launches
    ts = (q, k, v)
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
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention_cuda takes tensors on the card")
    code = build.dtype_code(q.dtype)
    if q.dtype == torch.bfloat16:
        need = smem_bytes(hd, BLOCK_K, STAGES)
        if need > SMEM_LIMIT:
            raise ValueError(f"hd={hd} needs {need} B of shared memory, over "
                             f"the block's {SMEM_LIMIT}")
        if any(t.data_ptr() % 16 for t in ts):
            raise ValueError("bf16 q, k and v must start on 16-byte "
                             "boundaries (TMA)")
    out = torch.empty_like(q)
    err = build.library().pmt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bkvh,
        sq, skv, hd, float(scale), int(causal), int(window or 0),
        float(softcap or 0.0), code, torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    launches += 1
    return out
