"""Wrapper of the CUDA chunked-prefill kernel
(``csrc/prefill_attention.cu``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.kernel import SMEM_LIMIT

# Launches of the kernel since the count was last set to 0.
launches = 0

_ROWS, _TILE = 16, 64     # packed query rows per block, keys per tile


def smem_bytes(hd: int, hdv: int) -> int:
    return 4 * (_ROWS * hd + _TILE * (hd + 1) + _TILE * hdv
                + _ROWS * _TILE + _ROWS * hdv + 3 * _ROWS)


def prefill_attention_cuda(q: torch.Tensor, k_chunk: torch.Tensor,
                           v_chunk: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, offs: torch.Tensor, *,
                           ring: bool = False, window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: float = 1.0) -> torch.Tensor:
    """q: (B, KVH, T, G, hdq); k_chunk/v_chunk: (B, T, KVH, hdq/hdv) of
    q's dtype; k_cache/v_cache: (B, C, KVH, hdq/hdv); offs: (B,) int32;
    all on the card and contiguous.  Returns (B, KVH, T, G, hdv) in
    q.dtype."""
    global launches
    ts = (q, k_chunk, v_chunk, k_cache, v_cache, offs)
    if not all(t.is_cuda for t in ts):
        raise ValueError("prefill_attention_cuda takes tensors on the card")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")
    if q.dim() != 5:
        raise ValueError("q must be (B, KVH, T, G, hd)")
    b, kvh, t, g, hd = q.shape
    c = k_cache.shape[1]
    hdv = v_cache.shape[-1]
    if k_chunk.shape != (b, t, kvh, hd) or v_chunk.shape != (b, t, kvh, hdv):
        raise ValueError(f"chunk k/v {tuple(k_chunk.shape)}/"
                         f"{tuple(v_chunk.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_cache.shape != (b, c, kvh, hd) or v_cache.shape != (b, c, kvh, hdv):
        raise ValueError(f"cache k/v {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not k_chunk.dtype == v_chunk.dtype == q.dtype:
        raise ValueError("chunk k/v must have q's dtype")
    if k_cache.dtype != v_cache.dtype:
        raise ValueError("cache k/v must share a dtype")
    if offs.dtype != torch.int32 or offs.shape != (b,):
        raise ValueError("offs must be a (B,) int32 tensor")
    if c < 1:
        raise ValueError("empty cache")
    if ring and (window is None or window <= 0):
        raise ValueError("ring caches need a window")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be > 0")
    if smem_bytes(hd, hdv) > SMEM_LIMIT:
        raise ValueError(f"hd={hd}, hdv={hdv} need more shared memory than "
                         f"a block has")
    qd, cd = build.dtype_code(q.dtype), build.dtype_code(k_cache.dtype)
    out = torch.empty((b, kvh, t, g, hdv), dtype=q.dtype, device=q.device)
    err = build.library().pmt_prefill_attention(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), offs.data_ptr(),
        out.data_ptr(), b, t, c, kvh, g, hd, hdv, float(scale), int(ring),
        int(window or 0), float(softcap or 0.0), qd, cd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "prefill_attention")
    launches += 1
    return out
