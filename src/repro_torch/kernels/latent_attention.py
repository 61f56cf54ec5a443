"""The launcher of the latent-attention kernels (``csrc/latent_attention.cu``):
attention over MLA's aliased latent cache, the values the first ``hdv``
lanes of the key rows, on the tensor cores, contiguous or paged, over a
bf16 cache or int8 / fp8_e4m3 codes: decode on ``mma.sync`` in blocks
of one or two 16-row tiles, the prefill chunk on ``wgmma`` in blocks of
64 rows fed by TMA.  The decode and prefill wrappers
(``decode_attention/kernel.py``, ``prefill_attention/kernel.py``) call
it for the inputs it takes (:func:`takes`) and count its launches as
theirs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, split_kv

MAX_HD, MAX_HDV = 576, 512
MAX_ROW_TILES = 2         # 16 packed query rows each, 4 warps a row tile
MAX_SPLITS = 8
KEYS_PER_SPLIT = 64       # fewest cache keys worth a split of their own
# cache dtypes it reads: bf16, and the codes it widens exactly to bf16
CACHE_DTYPES = (torch.bfloat16, torch.int8, torch.float8_e4m3fn)
_KT, _STAGES, _SLICES = 32, 3, 4
# the prefill kernel: 64 packed query rows a block (wgmma's M), 32-key
# tiles in a ring of three, two consumer warpgroups
PREFILL_ROWS = 64
PREFILL_KEYS_PER_SPLIT = 128


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, v_width,
          k_scale, v_scale, *, ring: bool = False, window=None,
          softcap=None) -> bool:
    """Whether the kernel takes these inputs: bf16 q over a bf16 or code
    cache ``k`` whose values are its own first ``v_width`` lanes (``v`` is
    ``k``, one scale tensor), no ring, window or softcap, hd <= 576 and
    v_width <= 512."""
    hd = k.shape[-1]
    return (v_width is not None and q.dtype == torch.bfloat16
            and k.dtype in CACHE_DTYPES and aliased(k, v)
            and (v_scale is None or aliased(k_scale, v_scale))
            and not ring and window is None and softcap is None
            and hd <= MAX_HD and 0 < v_width <= min(hd, MAX_HDV))


def aliased(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are the same elements (the same tensor, or
    views of the same storage with one shape and stride)."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def row_tiles(rows: int) -> int:
    """Row tiles of a block for ``rows`` = T * G packed query rows."""
    return max(1, min(math.ceil(rows / 16), MAX_ROW_TILES))


def split_count(groups: int, c: int, sms: int = 132) -> int:
    """Splits of the cache range for ``groups`` = B * KVH * row blocks
    blocks' worth of rows over a cache of capacity ``c``."""
    return split_kv.split_count(groups, c, sms, KEYS_PER_SPLIT, MAX_SPLITS)


def prefill_groups(b: int, kvh: int, t: int, g: int) -> int:
    """Row blocks of a prefill launch: B * KVH * ceil(T * G / 64)."""
    return b * kvh * math.ceil(t * g / PREFILL_ROWS)


def prefill_split_count(groups: int, c: int, sms: int = 132) -> int:
    """Splits of the cache range for ``groups`` prefill row blocks over a
    cache of capacity ``c``: one block an SM (its shared memory), so as
    many splits as fill the SMs once over, no more than one per
    PREFILL_KEYS_PER_SPLIT keys of the capacity, at most MAX_SPLITS."""
    return max(1, min(sms // groups, math.ceil(c / PREFILL_KEYS_PER_SPLIT),
                      MAX_SPLITS))


def prefill_smem_bytes(hd: int, codes: bool) -> int:
    """Dynamic shared memory of one prefill block (the library's
    ``pmt_latent_prefill_smem_bytes``): 1 KB of alignment slack, q (64
    rows), the ring of three key tiles, two buffers of p_hi | p_lo (64 x
    64 bf16), for codes one code tile and each stage's row scales, the
    two warpgroups' row maxima and the barriers (q, full and empty a
    stage, codes landed)."""
    dk = 128 if hd <= 128 else MAX_HD
    n = 1024 + 2 * dk * PREFILL_ROWS + _STAGES * 2 * dk * _KT \
        + 2 * 2 * PREFILL_ROWS * 64 + 2 * 4 * PREFILL_ROWS \
        + 8 * (2 + 2 * _STAGES)
    if codes:
        n += dk * _KT + _STAGES * 4 * _KT
    return n


def loads_by_tma(q: torch.Tensor, kx: torch.Tensor, kc: torch.Tensor,
                 page_size=None) -> bool:
    """Whether a prefill launch loads q, the chunk's keys and the cache by
    TMA (the library's ``pmt_latent_prefill_tma``): 16-byte-aligned bases,
    rows a whole number of 16-byte units (bf16 and cache rows), and page
    boxes of gcd(page_size, 16) >= 8 rows.  Otherwise its loading warp
    copies them element by element."""
    hd = q.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, kx, kc))
    return (aligned and 2 * hd % 16 == 0 and kc.element_size() * hd % 16 == 0
            and (page_size is None or math.gcd(page_size, 16) >= 8))


def smem_bytes(hd: int, codes: bool, tiles: int) -> int:
    """Dynamic shared memory of one decode block (the library's
    ``pmt_latent_smem_bytes``): q, the key ring, the warps' partial
    scores, and for codes the code ring and its row scales."""
    dk = 64 if hd <= 64 else 128 if hd <= 128 else MAX_HD
    n = 2 * (dk + 8) * (16 * tiles + _STAGES * _KT) \
        + 4 * 16 * _KT * _SLICES * tiles
    if codes:
        n += _STAGES * _KT * (dk + 16 + 4)
    return n


def launch(q: torch.Tensor, kx, kc: torch.Tensor, k_scale, pos: torch.Tensor,
           page_table, *, hdv: int, scale: float, decode: bool
           ) -> torch.Tensor:
    """Launch the decode or the prefill kernel.  q: (B, KVH, T, G, hd)
    bf16 (T = 1 with ``decode``); kx: the chunk's keys (B, T, KVH, hd)
    bf16, None with ``decode``; kc: the cache (B, C, KVH, hd) or, with a
    page table (B, NB) int32, the pools (P, ps, KVH, hd); k_scale: the
    codes' (rows, KVH) float32 scales; pos: (B,) int32 lens (decode) or
    chunk offsets.  All on the card and contiguous, checked by the
    caller.  Returns (B, KVH, T, G, hdv) bf16."""
    b, kvh, t, g, hd = q.shape
    if page_table is None:
        c, nb, ps = kc.shape[1], 1, kc.shape[1]
    else:
        nb, ps = page_table.shape[1], kc.shape[1]
        c = nb * ps
    dev = q.device
    if decode:
        tiles = row_tiles(t * g)
        groups = b * kvh * math.ceil(t * g / (16 * tiles))
        nsplit = split_count(groups, c, split_kv.sm_count(dev))
        rows = 16 * tiles
    else:
        groups = prefill_groups(b, kvh, t, g)
        nsplit = prefill_split_count(groups, c, split_kv.sm_count(dev))
        rows = PREFILL_ROWS
    tickets, stream = split_kv.tickets(dev, groups)
    ws = torch.empty(groups * nsplit * rows * (hdv + 2)
                     if nsplit > 1 else 0, dtype=torch.float32, device=dev)
    out = torch.empty((b, kvh, t, g, hdv), dtype=q.dtype, device=dev)
    codes = k_scale is not None
    ptrs = (q.data_ptr(), None if kx is None else kx.data_ptr(),
            kc.data_ptr(), k_scale.data_ptr() if codes else None,
            pos.data_ptr(),
            None if page_table is None else page_table.data_ptr(),
            out.data_ptr(), ws.data_ptr() if nsplit > 1 else None,
            tickets.data_ptr())
    cd = build.dtype_code(kc.dtype, codes=codes)
    paged = int(page_table is not None)
    if decode:
        err = build.library().pmt_latent_attention(
            *ptrs, b, t, c, nb, ps, kvh, g, hd, hdv, float(scale), 1, paged,
            cd, nsplit, tiles, stream)
    else:
        err = build.library().pmt_latent_prefill(
            *ptrs, b, t, c, nb, ps, kc.shape[0], kvh, g, hd, hdv,
            float(scale), paged, cd, nsplit, stream)
    build.check(err, "latent_attention")
    return out
