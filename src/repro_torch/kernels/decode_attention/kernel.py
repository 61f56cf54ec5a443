"""Wrappers of the CUDA flash-decode kernel (``csrc/decode_attention.cu``)
over a contiguous cache and over page pools."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# Launches of each kernel since its count was last set to 0.
launches = 0            # decode_attention_cuda
paged_launches = 0      # decode_attention_paged_cuda

# Shared-memory budget of one block on the H100 (227 KB usable).
SMEM_LIMIT = 232448
_TILE = 64          # keys per tile, as in the source


def smem_bytes(g: int, hd: int, hdv: int) -> int:
    """Dynamic shared memory of one block, plus its static row table."""
    return 4 * (g * hd + _TILE * (hd + 1) + _TILE * hdv + g * _TILE
                + g * hdv + 3 * g + _TILE)


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


def decode_attention_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                page_table: torch.Tensor, lens: torch.Tensor,
                                *, window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                scale: float = 1.0) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k_pool: (P, page_size, KVH, hdq), v_pool:
    (P, page_size, KVH, hdv), page_table: (B, NB) int32 with every entry
    a page of the pools, lens: (B,) int32, all on the card and
    contiguous.  Returns (B, KVH, G, hdv) in q.dtype."""
    global paged_launches
    ts = (q, k_pool, v_pool, page_table, lens)
    if not all(t.is_cuda for t in ts):
        raise ValueError("decode_attention_paged_cuda takes tensors on the "
                         "card")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q, k_pool, v_pool must be 4-D")
    b, kvh, g, hd = q.shape
    p, ps = k_pool.shape[:2]
    hdv = v_pool.shape[-1]
    if k_pool.shape != (p, ps, kvh, hd) or v_pool.shape[:3] != (p, ps, kvh):
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pool.dtype != v_pool.dtype:
        raise ValueError("k_pool and v_pool must share a dtype")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or page_table.shape[1] < 1:
        raise ValueError(f"page_table must be a ({b}, NB >= 1) int32 tensor")
    if lens.dtype != torch.int32 or lens.shape != (b,):
        raise ValueError("lens must be a (B,) int32 tensor")
    if window is not None and window <= 0:
        raise ValueError("window must be > 0")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be > 0")
    if smem_bytes(g, hd, hdv) > SMEM_LIMIT:
        raise ValueError(f"G={g}, hd={hd}, hdv={hdv} need more shared "
                         f"memory than a block has")
    qd, kd = build.dtype_code(q.dtype), build.dtype_code(k_pool.dtype)
    out = torch.empty((b, kvh, g, hdv), dtype=q.dtype, device=q.device)
    err = build.library().pmt_decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(), b,
        page_table.shape[1], ps, kvh, g, hd, hdv, float(scale),
        int(window or 0), float(softcap or 0.0), qd, kd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "decode_attention_paged")
    paged_launches += 1
    return out
