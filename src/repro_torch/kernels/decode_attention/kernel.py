"""Wrappers of the CUDA flash-decode kernel (``csrc/decode_attention.cu``)
over a contiguous cache and over page pools, each also over quantized
caches: int8 / fp8_e4m3 codes with float32 row scales, dequantized in
the kernel."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# Launches of each kernel since its count was last set to 0.
# The quantized launches (``k_scale`` given) count apart from the others.
launches = 0                # decode_attention_cuda
paged_launches = 0          # decode_attention_paged_cuda
quant_launches = 0          # decode_attention_cuda over codes
quant_paged_launches = 0    # decode_attention_paged_cuda over codes

# Shared-memory budget of one block on the H100 (227 KB usable).
SMEM_LIMIT = 232448
_TILE = 64          # keys per tile, as in the source


def smem_bytes(g: int, hd: int, hdv: int) -> int:
    """Dynamic shared memory of one block, plus its static row table and
    the two row-scale arrays of a quantized tile."""
    return 4 * (g * hd + _TILE * (hd + 1) + _TILE * hdv + g * _TILE
                + g * hdv + 3 * g + 3 * _TILE)


def cache_codes(kv: torch.Tensor, k_scale, v_scale, rows: tuple):
    """The C side's element-type code of a cache or pool ``kv`` (already
    checked to share its dtype with its partner), and the two scale
    pointers: 0 for an unquantized cache, which takes no scales; for a
    code dtype, ``k_scale``/``v_scale`` must be contiguous float32
    tensors of shape ``rows`` on the card (``v_scale`` defaults to
    ``k_scale``)."""
    if k_scale is None:
        if v_scale is not None:
            raise ValueError("v_scale without k_scale")
        return build.dtype_code(kv.dtype), 0, 0
    v_scale = k_scale if v_scale is None else v_scale
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if not t.is_cuda or t.dtype != torch.float32 \
                or tuple(t.shape) != rows or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {rows} "
                             f"tensor on the card")
    return build.dtype_code(kv.dtype, codes=True), k_scale.data_ptr(), \
        v_scale.data_ptr()


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor, *, ring: bool = False,
                          softcap: Optional[float] = None,
                          scale: float = 1.0, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k: (B, C, KVH, hdq), v: (B, C, KVH, hdv),
    lens: (B,) int32, all on the card and contiguous.  With ``k_scale``
    (and ``v_scale``, default ``k_scale``): k, v hold int8 or
    float8_e4m3fn codes with (B, C, KVH) float32 row scales.  Returns
    (B, KVH, G, hdv) in q.dtype."""
    global launches, quant_launches
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
    qd = build.dtype_code(q.dtype)
    kd, ksp, vsp = cache_codes(k, k_scale, v_scale, (b, c, kvh))
    out = torch.empty((b, kvh, g, hdv), dtype=q.dtype, device=q.device)
    err = build.library().pmt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ksp, vsp, lens.data_ptr(),
        out.data_ptr(), b, c, kvh, g, hd, hdv, float(scale), int(ring),
        float(softcap or 0.0), qd, kd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "decode_attention")
    if k_scale is None:
        launches += 1
    else:
        quant_launches += 1
    return out


def decode_attention_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                page_table: torch.Tensor, lens: torch.Tensor,
                                *, window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                scale: float = 1.0, k_scale=None,
                                v_scale=None) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k_pool: (P, page_size, KVH, hdq), v_pool:
    (P, page_size, KVH, hdv), page_table: (B, NB) int32 with every entry
    a page of the pools, lens: (B,) int32, all on the card and
    contiguous.  With ``k_scale`` (and ``v_scale``, default ``k_scale``):
    the pools hold int8 or float8_e4m3fn codes with (P, page_size, KVH)
    float32 scale pools paged like them.  Returns (B, KVH, G, hdv) in
    q.dtype."""
    global paged_launches, quant_paged_launches
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
    qd = build.dtype_code(q.dtype)
    kd, ksp, vsp = cache_codes(k_pool, k_scale, v_scale, (p, ps, kvh))
    out = torch.empty((b, kvh, g, hdv), dtype=q.dtype, device=q.device)
    err = build.library().pmt_decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ksp, vsp,
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(), b,
        page_table.shape[1], ps, kvh, g, hd, hdv, float(scale),
        int(window or 0), float(softcap or 0.0), qd, kd,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "decode_attention_paged")
    if k_scale is None:
        paged_launches += 1
    else:
        quant_paged_launches += 1
    return out
