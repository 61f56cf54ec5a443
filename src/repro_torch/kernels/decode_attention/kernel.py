"""Wrapper of the CUDA flash-decode kernel (``csrc/decode_attention.cu``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# Launches of the kernel since the count was last set to 0.
launches = 0

# Shared-memory budget of one block on the H100 (227 KB usable).
SMEM_LIMIT = 232448
_TILE = 64          # keys per tile, as in the source


def smem_bytes(g: int, hd: int, hdv: int) -> int:
    return 4 * (g * hd + _TILE * (hd + 1) + _TILE * hdv + g * _TILE
                + g * hdv + 3 * g)


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor, *, ring: bool = False,
                          softcap: Optional[float] = None,
                          scale: float = 1.0) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k: (B, C, KVH, hdq), v: (B, C, KVH, hdv),
    lens: (B,) int32, all on the card and contiguous.  Returns
    (B, KVH, G, hdv) in q.dtype."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda and lens.is_cuda):
        raise ValueError("decode_attention_cuda takes tensors on the card")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D")
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    hdv = v.shape[-1]
    if k.shape != (b, c, kvh, hd) or v.shape[:3] != (b, c, kvh):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.dtype != v.dtype:
        raise ValueError("k and v must share a dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if lens.dtype != torch.int32 or lens.shape != (b,) \
            or not lens.is_contiguous():
        raise ValueError("lens must be a contiguous (B,) int32 tensor")
    if c < 1:
        raise ValueError("empty cache")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be > 0")
    if smem_bytes(g, hd, hdv) > SMEM_LIMIT:
        raise ValueError(f"G={g}, hd={hd}, hdv={hdv} need more shared "
                         f"memory than a block has")
    qd, kd = build.dtype_code(q.dtype), build.dtype_code(k.dtype)
    out = torch.empty((b, kvh, g, hdv), dtype=q.dtype, device=q.device)
    err = build.library().pmt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), b, c, kvh, g, hd, hdv, float(scale), int(ring),
        float(softcap or 0.0), qd, kd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "decode_attention")
    launches += 1
    return out
