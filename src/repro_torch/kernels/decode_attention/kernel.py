"""Wrappers of the CUDA flash-decode kernel (``csrc/decode_attention.cu``)
over a contiguous cache and over page pools, each also over quantized
caches: int8 / fp8_e4m3 codes with float32 row scales, dequantized in
the kernel.  The kernel splits each row's keys over blocks (split-KV);
the wrappers pick the split count and hand it a workspace and the
tickets of ``split_kv``.  With ``v_width`` (MLA's aliased latent cache:
the values are the first lanes of v, which may be k) a bf16 q over an
aliased cache launches the tensor-core ``latent_attention`` kernel, the
other inputs this kernel with v's row width passed apart."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, latent_attention, split_kv

# Launches of each kernel since its count was last set to 0.
# The quantized launches (``k_scale`` given) count apart from the others.
launches = 0                # decode_attention_cuda
paged_launches = 0          # decode_attention_paged_cuda
quant_launches = 0          # decode_attention_cuda over codes
quant_paged_launches = 0    # decode_attention_paged_cuda over codes
# The v_width launches (rows 3v, 7v and their quantized branches).
v_launches = 0
v_paged_launches = 0
v_quant_launches = 0
v_quant_paged_launches = 0

# Shared-memory budget of one block on the H100 (227 KB usable); the
# prefill wrappers check theirs against it.
SMEM_LIMIT = 232448
WIDTHS = (64, 128, 256, 512)   # the kernel's head widths D, as the source
WARPS = 4
MAX_SPLITS = 8            # the split count's cap
KERNEL_SPLITS = 16        # the most the kernel takes (its fold's registers)
KEYS_PER_SPLIT = 64       # fewest keys of the capacity worth a split


def width(hd: int, hdv: int) -> int:
    """The kernel's head width D for these heads: the smallest of WIDTHS
    that holds both (0 where none does)."""
    return next((d for d in WIDTHS if max(hd, hdv) <= d), 0)


def heads_per_block(hd: int, hdv: int) -> int:
    """Query heads a block takes: 4, or 2 at D 512, where a lane holds
    two chunks of a row."""
    return 2 if width(hd, hdv) == 512 else 4


def smem_bytes(hd: int, hdv: int) -> int:
    """Dynamic shared memory of one block (the library's
    ``pmt_decode_smem_bytes``): the warps' partials and weights, the
    block's max and sum, the fold's weights, for its query heads.  G is
    split over blocks of ``heads_per_block``, so it does not enter; at
    most 16,624 B (hdv 512), under the 48 KB a launch takes without
    opting in."""
    h = heads_per_block(hd, hdv)
    return 4 * h * (WARPS * (hdv + 2) + WARPS + 2 + KERNEL_SPLITS)


def split_count(groups: int, c: int, sms: int = 132) -> int:
    """Splits of each row's keys for ``groups`` = B * KVH * head groups
    blocks' worth of rows over a cache of capacity ``c``
    (``split_kv.split_count``): at most MAX_SPLITS, none shorter than
    KEYS_PER_SPLIT keys of the capacity."""
    return split_kv.split_count(groups, c, sms, KEYS_PER_SPLIT, MAX_SPLITS)


def _check_heads(hd: int, hdv: int) -> None:
    if not width(hd, hdv):
        raise ValueError(f"hd={hd}, hdv={hdv}: the kernel takes heads up "
                         f"to {WIDTHS[-1]} wide")


def _value_width(v: torch.Tensor, v_width) -> int:
    """hdv: ``v_width``, which must lie in (0, v's width], or v's width."""
    if v_width is None:
        return v.shape[-1]
    if not 0 < v_width <= v.shape[-1]:
        raise ValueError(f"v_width={v_width} outside (0, {v.shape[-1]}]")
    return int(v_width)


def _count(v_width, k_scale, paged: bool) -> None:
    """One launch on the counter of its row: ``[v_][quant_][paged_]
    launches``."""
    name = ("v_" if v_width is not None else "") \
        + ("quant_" if k_scale is not None else "") \
        + ("paged_" if paged else "") + "launches"
    globals()[name] += 1


def _latent(q, kc, k_scale, lens, page_table, hdv, scale):
    """The latent-attention kernel over a decode step (T = 1)."""
    b, kvh, g, hd = q.shape
    out = latent_attention.launch(q.view(b, kvh, 1, g, hd), None, kc,
                                  k_scale, lens, page_table, hdv=hdv,
                                  scale=scale, decode=True)
    return out.view(b, kvh, g, hdv)


def _launch(entry: str, q: torch.Tensor, ptrs: tuple, scalars: tuple,
            c: int, hdv: int) -> torch.Tensor:
    """Launch ``entry`` with its input pointers ``ptrs``, then out, the
    split workspace and the tickets, then its shape and option arguments
    ``scalars``, the split count and the stream; ``c`` is the cache's
    capacity in positions.  Returns the output."""
    b, kvh, g, hd = q.shape
    heads = heads_per_block(hd, hdv)
    groups = b * kvh * math.ceil(g / heads)
    dev = q.device
    nsplit = split_count(groups, c, split_kv.sm_count(dev))
    tickets, stream = split_kv.tickets(dev, groups)
    ws = torch.empty(groups * nsplit * heads * (hdv + 2) if nsplit > 1
                     else 0, dtype=torch.float32, device=dev)
    out = torch.empty((b, kvh, g, hdv), dtype=q.dtype, device=dev)
    err = getattr(build.library(), entry)(
        *ptrs, out.data_ptr(), ws.data_ptr() if nsplit > 1 else None,
        tickets.data_ptr(), *scalars, nsplit, stream)
    build.check(err, entry[4:])
    return out


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
                          scale: float = 1.0, v_width=None, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k: (B, C, KVH, hdq), v: (B, C, KVH, hdv),
    lens: (B,) int32, all on the card and contiguous.  With ``k_scale``
    (and ``v_scale``, default ``k_scale``): k, v hold int8 or
    float8_e4m3fn codes with (B, C, KVH) float32 row scales.  With
    ``v_width`` the values are v's first ``v_width`` lanes (v may be k).
    Returns (B, KVH, G, hdv) in q.dtype."""
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
    vld, hdv = hdv, _value_width(v, v_width)
    kd, ksp, vsp = cache_codes(k, k_scale, v_scale, (b, c, kvh))
    if latent_attention.takes(q, k, v, v_width, k_scale, v_scale, ring=ring,
                              softcap=softcap):
        out = _latent(q, k, k_scale, lens, None, hdv, scale)
    else:
        _check_heads(hd, hdv)
        out = _launch("pmt_decode_attention", q,
                      (q.data_ptr(), k.data_ptr(), v.data_ptr(), ksp, vsp,
                       lens.data_ptr()),
                      (b, c, kvh, g, hd, hdv, vld, float(scale), int(ring),
                       float(softcap or 0.0), build.dtype_code(q.dtype), kd),
                      c, hdv)
    _count(v_width, k_scale, paged=False)
    return out


def decode_attention_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                page_table: torch.Tensor, lens: torch.Tensor,
                                *, window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                scale: float = 1.0, v_width=None,
                                k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, KVH, G, hdq), k_pool: (P, page_size, KVH, hdq), v_pool:
    (P, page_size, KVH, hdv), page_table: (B, NB) int32 with every entry
    a page of the pools, lens: (B,) int32, all on the card and
    contiguous.  With ``k_scale`` (and ``v_scale``, default ``k_scale``):
    the pools hold int8 or float8_e4m3fn codes with (P, page_size, KVH)
    float32 scale pools paged like them.  ``v_width`` as in
    :func:`decode_attention_cuda`.  Returns (B, KVH, G, hdv) in q.dtype."""
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
    vld, hdv = hdv, _value_width(v_pool, v_width)
    kd, ksp, vsp = cache_codes(k_pool, k_scale, v_scale, (p, ps, kvh))
    nb = page_table.shape[1]
    if latent_attention.takes(q, k_pool, v_pool, v_width, k_scale, v_scale,
                              window=window, softcap=softcap):
        out = _latent(q, k_pool, k_scale, lens, page_table, hdv, scale)
    else:
        _check_heads(hd, hdv)
        out = _launch("pmt_decode_attention_paged", q,
                      (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                       ksp, vsp, page_table.data_ptr(), lens.data_ptr()),
                      (b, nb, ps, kvh, g, hd, hdv, vld, float(scale),
                       int(window or 0), float(softcap or 0.0),
                       build.dtype_code(q.dtype), kd), nb * ps, hdv)
    _count(v_width, k_scale, paged=True)
    return out
