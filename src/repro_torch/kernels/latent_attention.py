"""The launcher of the latent-attention kernel (``csrc/latent_attention.cu``):
attention over MLA's aliased latent cache, the values the first ``hdv``
lanes of the key rows, on the tensor cores, for decode and for the
prefill chunk, contiguous or paged, over a bf16 cache or int8 / fp8_e4m3
codes.  The decode and prefill wrappers (``decode_attention/kernel.py``,
``prefill_attention/kernel.py``) call it for the inputs it takes
(:func:`takes`) and count its launches as theirs.
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


def smem_bytes(hd: int, codes: bool, tiles: int) -> int:
    """Dynamic shared memory of one block (the library's
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
    """Launch the kernel.  q: (B, KVH, T, G, hd) bf16 (T = 1 with
    ``decode``); kx: the chunk's keys (B, T, KVH, hd) bf16, None with
    ``decode``; kc: the cache (B, C, KVH, hd) or, with a page table
    (B, NB) int32, the pools (P, ps, KVH, hd); k_scale: the codes' (rows,
    KVH) float32 scales; pos: (B,) int32 lens (decode) or chunk offsets.
    All on the card and contiguous, checked by the caller.  Returns
    (B, KVH, T, G, hdv) bf16."""
    b, kvh, t, g, hd = q.shape
    if page_table is None:
        c, nb, ps = kc.shape[1], 1, kc.shape[1]
    else:
        nb, ps = page_table.shape[1], kc.shape[1]
        c = nb * ps
    tiles = row_tiles(t * g)
    groups = b * kvh * math.ceil(t * g / (16 * tiles))
    dev = q.device
    nsplit = split_count(groups, c, split_kv.sm_count(dev))
    tickets, stream = split_kv.tickets(dev, groups)
    ws = torch.empty(groups * nsplit * 16 * tiles * (hdv + 2)
                     if nsplit > 1 else 0, dtype=torch.float32, device=dev)
    out = torch.empty((b, kvh, t, g, hdv), dtype=q.dtype, device=dev)
    codes = k_scale is not None
    err = build.library().pmt_latent_attention(
        q.data_ptr(), None if kx is None else kx.data_ptr(), kc.data_ptr(),
        k_scale.data_ptr() if codes else None, pos.data_ptr(),
        None if page_table is None else page_table.data_ptr(),
        out.data_ptr(), ws.data_ptr() if nsplit > 1 else None,
        tickets.data_ptr(), b, t, c, nb, ps, kvh, g, hd, hdv, float(scale),
        int(decode), int(page_table is not None),
        build.dtype_code(kc.dtype, codes=codes), nsplit, tiles, stream)
    build.check(err, "latent_attention")
    return out
