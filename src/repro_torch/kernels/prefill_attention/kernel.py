"""Wrappers of the CUDA chunked-prefill kernels
(``csrc/prefill_attention.cu``) over a contiguous cache and over page
pools, each also over a quantized cache prefix: int8 / fp8_e4m3 codes
with float32 row scales, read as codes by the kernel.

When q and the chunk are bf16, the cache bf16 or codes, and the heads at
most 128 wide, the wrappers launch the tensor-core kernel, split over
blocks along the cache (split-KV); the other inputs (fp32 q, wider
heads) take the CUDA-core kernel.  With ``v_width`` (MLA's aliased
latent cache: the values are the first lanes of v, which may be k) bf16
inputs over an aliased cache launch the tensor-core ``latent_attention``
kernel, the others the CUDA-core kernel with v's row width passed apart.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, latent_attention, split_kv
from repro_torch.kernels.decode_attention.kernel import SMEM_LIMIT, \
    cache_codes

# Launches of each kernel since its count was last set to 0.  The
# quantized launches (``k_scale`` given) count apart from the others.
launches = 0                # prefill_attention_cuda
paged_launches = 0          # prefill_attention_paged_cuda
quant_launches = 0          # prefill_attention_cuda over codes
quant_paged_launches = 0    # prefill_attention_paged_cuda over codes
# The v_width launches (rows 2v, 8v and their quantized branches).
v_launches = 0
v_paged_launches = 0
v_quant_launches = 0
v_quant_paged_launches = 0

_ROWS, _TILE = 16, 64     # packed query rows per block, keys per tile

# The tensor-core kernel (``tc::prefill_tc_kernel``).
TC_MAX_HD = 128           # widest hd / hdv it takes
TC_MAX_WARPS = 8          # 16 packed query rows each
TC_MAX_SPLITS = 8
TC_KEYS_PER_SPLIT = 64    # fewest cache keys worth a split of their own
# cache dtypes it reads: bf16, and the codes it widens exactly to bf16
TC_CACHE_DTYPES = (torch.bfloat16, torch.int8, torch.float8_e4m3fn)


def uses_tensor_cores(q_dtype, cache_dtype, hd: int, hdv: int) -> bool:
    """Whether these inputs take the tensor-core kernel."""
    return (q_dtype == torch.bfloat16 and cache_dtype in TC_CACHE_DTYPES
            and max(hd, hdv) <= TC_MAX_HD)


def tc_warps(rows: int) -> int:
    """Warps of a tensor-core block for ``rows`` = T * G packed query
    rows: one per 16 rows, at most TC_MAX_WARPS."""
    return max(1, min(math.ceil(rows / 16), TC_MAX_WARPS))


def split_count(groups: int, c: int, sms: int = 132) -> int:
    """Splits of the cache range for ``groups`` = B * KVH * row tiles
    blocks' worth of rows over a cache of capacity ``c``
    (``split_kv.split_count``): at most TC_MAX_SPLITS, none shorter than
    TC_KEYS_PER_SPLIT keys of the capacity."""
    return split_kv.split_count(groups, c, sms, TC_KEYS_PER_SPLIT,
                                TC_MAX_SPLITS)


def _tc_launch(entry: str, q: torch.Tensor, ptrs: tuple, scalars: tuple,
               c: int, hdv: int) -> torch.Tensor:
    """Launch the tensor-core entry point ``entry``: its input pointers
    ``ptrs``, then out, the split workspace and the tickets, then its
    shape and option arguments and the cache's dtype code ``scalars``,
    the split count and the warps; ``c`` is the cache's capacity in
    positions."""
    b, kvh, t, g, _ = q.shape
    nwarps = tc_warps(t * g)
    groups = b * kvh * math.ceil(t * g / (16 * nwarps))
    dev = q.device
    nsplit = split_count(groups, c, split_kv.sm_count(dev))
    tickets, stream = split_kv.tickets(dev, groups)
    ws = torch.empty(groups * nsplit * 16 * nwarps * (hdv + 2)
                     if nsplit > 1 else 0, dtype=torch.float32, device=dev)
    out = torch.empty((b, kvh, t, g, hdv), dtype=q.dtype, device=dev)
    err = getattr(build.library(), entry)(
        *ptrs, out.data_ptr(), ws.data_ptr() if nsplit > 1 else None,
        tickets.data_ptr(), *scalars, nsplit, nwarps, stream)
    build.check(err, entry[4:])
    return out


def _count(v_width, k_scale, paged: bool) -> None:
    """One launch on the counter of its row: ``[v_][quant_][paged_]
    launches``."""
    name = ("v_" if v_width is not None else "") \
        + ("quant_" if k_scale is not None else "") \
        + ("paged_" if paged else "") + "launches"
    globals()[name] += 1


def _widths(v_chunk, v_cache, v_width) -> tuple:
    """(vld, hdv): v's row width, shared by the chunk and the cache, and
    the values' width, ``v_width`` in (0, vld] or vld."""
    vld = v_cache.shape[-1]
    if v_chunk.shape[-1] != vld:
        raise ValueError("chunk and cache v rows differ in width")
    if v_width is None:
        return vld, vld
    if not 0 < v_width <= vld:
        raise ValueError(f"v_width={v_width} outside (0, {vld}]")
    return vld, int(v_width)


def smem_bytes(hd: int, hdv: int) -> int:
    """Dynamic shared memory of one block, plus its static row table and
    the two row-scale arrays of a quantized tile."""
    return 4 * (_ROWS * hd + _TILE * (hd + 1) + _TILE * hdv
                + _ROWS * _TILE + _ROWS * hdv + 3 * _ROWS + 3 * _TILE)


def prefill_attention_cuda(q: torch.Tensor, k_chunk: torch.Tensor,
                           v_chunk: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, offs: torch.Tensor, *,
                           ring: bool = False, window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: float = 1.0, v_width=None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """q: (B, KVH, T, G, hdq); k_chunk/v_chunk: (B, T, KVH, hdq/hdv) of
    q's dtype; k_cache/v_cache: (B, C, KVH, hdq/hdv); offs: (B,) int32;
    all on the card and contiguous.  With ``k_scale`` (and ``v_scale``,
    default ``k_scale``): the cache holds int8 or float8_e4m3fn codes
    with (B, C, KVH) float32 row scales.  With ``v_width`` the values are
    the first ``v_width`` lanes of v_chunk and v_cache (which may be
    k_chunk and k_cache).  Returns (B, KVH, T, G, hdv) in q.dtype."""
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
    vld, hdv = _widths(v_chunk, v_cache, v_width)
    qd = build.dtype_code(q.dtype)
    cd, ksp, vsp = cache_codes(k_cache, k_scale, v_scale, (b, c, kvh))
    opts = (float(scale), int(ring), int(window or 0), float(softcap or 0.0))
    if latent_attention.takes(q, k_cache, v_cache, v_width, k_scale, v_scale,
                              ring=ring, window=window, softcap=softcap) \
            and latent_attention.aliased(k_chunk, v_chunk):
        out = latent_attention.launch(q, k_chunk, k_cache, k_scale, offs,
                                      None, hdv=hdv, scale=scale,
                                      decode=False)
    elif smem_bytes(hd, hdv) > SMEM_LIMIT:
        raise ValueError(f"hd={hd}, hdv={hdv} need more shared memory than "
                         f"a block has")
    elif v_width is None and uses_tensor_cores(q.dtype, k_cache.dtype, hd,
                                               hdv):
        out = _tc_launch(
            "pmt_prefill_attention_tc", q,
            (q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
             k_cache.data_ptr(), v_cache.data_ptr(), ksp, vsp,
             offs.data_ptr()),
            (b, t, c, kvh, g, hd, hdv, *opts, cd), c, hdv)
    else:
        out = torch.empty((b, kvh, t, g, hdv), dtype=q.dtype,
                          device=q.device)
        err = build.library().pmt_prefill_attention(
            q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), ksp, vsp,
            offs.data_ptr(), out.data_ptr(), b, t, c, kvh, g, hd, hdv, vld,
            *opts, qd, cd, torch.cuda.current_stream().cuda_stream)
        build.check(err, "prefill_attention")
    _count(v_width, k_scale, paged=False)
    return out


def prefill_attention_paged_cuda(q: torch.Tensor, k_chunk: torch.Tensor,
                                 v_chunk: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 page_table: torch.Tensor, offs: torch.Tensor,
                                 *, window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: float = 1.0, v_width=None,
                                 k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, KVH, T, G, hdq); k_chunk/v_chunk: (B, T, KVH, hdq/hdv) of
    q's dtype; k_pool/v_pool: (P, page_size, KVH, hdq/hdv); page_table:
    (B, NB) int32 with every entry a page of the pools; offs: (B,) int32;
    all on the card and contiguous.  With ``k_scale`` (and ``v_scale``,
    default ``k_scale``): the pools hold int8 or float8_e4m3fn codes with
    (P, page_size, KVH) float32 scale pools paged like them.
    ``v_width`` as in :func:`prefill_attention_cuda`.  Returns
    (B, KVH, T, G, hdv) in q.dtype."""
    ts = (q, k_chunk, v_chunk, k_pool, v_pool, page_table, offs)
    if not all(t.is_cuda for t in ts):
        raise ValueError("prefill_attention_paged_cuda takes tensors on the "
                         "card")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("inputs must be contiguous")
    if q.dim() != 5 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q must be (B, KVH, T, G, hd), the pools "
                         "(P, page_size, KVH, hd)")
    b, kvh, t, g, hd = q.shape
    p, ps = k_pool.shape[:2]
    hdv = v_pool.shape[-1]
    if k_chunk.shape != (b, t, kvh, hd) or v_chunk.shape != (b, t, kvh, hdv):
        raise ValueError(f"chunk k/v {tuple(k_chunk.shape)}/"
                         f"{tuple(v_chunk.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pool.shape != (p, ps, kvh, hd) or v_pool.shape != (p, ps, kvh, hdv):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not k_chunk.dtype == v_chunk.dtype == q.dtype:
        raise ValueError("chunk k/v must have q's dtype")
    if k_pool.dtype != v_pool.dtype:
        raise ValueError("k_pool and v_pool must share a dtype")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or page_table.shape[1] < 1:
        raise ValueError(f"page_table must be a ({b}, NB >= 1) int32 tensor")
    if offs.dtype != torch.int32 or offs.shape != (b,):
        raise ValueError("offs must be a (B,) int32 tensor")
    if window is not None and window <= 0:
        raise ValueError("window must be > 0")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be > 0")
    vld, hdv = _widths(v_chunk, v_pool, v_width)
    qd = build.dtype_code(q.dtype)
    cd, ksp, vsp = cache_codes(k_pool, k_scale, v_scale, (p, ps, kvh))
    nb = page_table.shape[1]
    opts = (float(scale), int(window or 0), float(softcap or 0.0))
    if latent_attention.takes(q, k_pool, v_pool, v_width, k_scale, v_scale,
                              window=window, softcap=softcap) \
            and latent_attention.aliased(k_chunk, v_chunk):
        out = latent_attention.launch(q, k_chunk, k_pool, k_scale, offs,
                                      page_table, hdv=hdv, scale=scale,
                                      decode=False)
    elif smem_bytes(hd, hdv) > SMEM_LIMIT:
        raise ValueError(f"hd={hd}, hdv={hdv} need more shared memory than "
                         f"a block has")
    elif v_width is None and uses_tensor_cores(q.dtype, k_pool.dtype, hd,
                                               hdv):
        out = _tc_launch(
            "pmt_prefill_attention_paged_tc", q,
            (q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), ksp, vsp,
             page_table.data_ptr(), offs.data_ptr()),
            (b, t, nb, ps, kvh, g, hd, hdv, *opts, cd), nb * ps, hdv)
    else:
        out = torch.empty((b, kvh, t, g, hdv), dtype=q.dtype,
                          device=q.device)
        err = build.library().pmt_prefill_attention_paged(
            q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(), ksp, vsp,
            page_table.data_ptr(), offs.data_ptr(), out.data_ptr(), b, t,
            nb, ps, kvh, g, hd, hdv, vld, *opts, qd, cd,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "prefill_attention_paged")
    _count(v_width, k_scale, paged=True)
    return out
