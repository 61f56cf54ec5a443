"""The launcher of the latent-attention kernel (``csrc/latent_attention.cu``):
attention over MLA's aliased latent cache, the values the first ``hdv``
lanes of the key rows, on the tensor cores, contiguous or paged, over a
bf16 cache or int8 / fp8_e4m3 codes: ``wgmma`` in blocks of 64 packed
query rows fed by TMA, for the decode step and the prefill chunk alike,
the splits of a block's keys folded across a thread-block cluster.  The
decode and prefill wrappers (``decode_attention/kernel.py``,
``prefill_attention/kernel.py``) call it for the inputs it takes
(:func:`takes`) and count its launches as theirs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, split_kv

MAX_HD, MAX_HDV = 576, 512
# cache dtypes it reads: bf16, and the codes it widens exactly to bf16
CACHE_DTYPES = (torch.bfloat16, torch.int8, torch.float8_e4m3fn)
# 64 packed query rows a block (wgmma's M), 32-key tiles in a ring of
# three, two consumer warpgroups; at most 8 splits (a portable cluster)
ROWS = 64
_KT, _STAGES = 32, 3
MAX_SPLITS = 8
# fewest cache keys worth a split of their own: a prefill chunk's last
# split also takes the chunk's keys, a decode split only its share
PREFILL_KEYS_PER_SPLIT = 128
DECODE_KEYS_PER_SPLIT = 64


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


def prefill_groups(b: int, kvh: int, t: int, g: int) -> int:
    """Row blocks (groups, each one cluster of splits) of a prefill
    launch: B * KVH * ceil(T * G / 64)."""
    return b * kvh * math.ceil(t * g / ROWS)


def _splits(groups: int, c: int, sms: int, keys_per_split: int) -> int:
    # one block an SM (its shared memory): as many splits as fill the SMs
    # once over, no more than one per keys_per_split keys of the capacity
    return max(1, min(sms // groups, math.ceil(c / keys_per_split),
                      MAX_SPLITS))


def prefill_split_count(groups: int, c: int, sms: int = 132) -> int:
    """Splits of the cache range for ``groups`` prefill row blocks over a
    cache of capacity ``c`` (the library's ``pmt_latent_splits``): as many
    as fill the ``sms`` SMs once over, no more than one per
    PREFILL_KEYS_PER_SPLIT keys of the capacity, at most MAX_SPLITS."""
    return _splits(groups, c, sms, PREFILL_KEYS_PER_SPLIT)


def decode_groups(b: int, kvh: int, g: int) -> int:
    """Row blocks of a decode launch (T = 1): B * KVH * ceil(G / 64); 16
    at deepseek-v3's B8 over 128 heads."""
    return prefill_groups(b, kvh, 1, g)


def decode_split_count(groups: int, c: int, sms: int = 132) -> int:
    """Splits of the cache range for ``groups`` decode row blocks over a
    cache of capacity ``c`` (the library's ``pmt_latent_splits``): as
    :func:`prefill_split_count`, one per DECODE_KEYS_PER_SPLIT keys; 8 at
    B8 over C 1024, so 128 blocks, one wave on 132 SMs."""
    return _splits(groups, c, sms, DECODE_KEYS_PER_SPLIT)


def smem_bytes(hd: int, codes: bool) -> int:
    """Dynamic shared memory of one block (the library's
    ``pmt_latent_smem_bytes``): 1 KB of alignment slack, q (64 rows), the
    ring of three key tiles, two buffers of p_hi | p_lo (64 x 64 bf16),
    for codes one code tile and each stage's row scales, the two
    warpgroups' row maxima and the barriers (q, full and empty a stage,
    codes landed)."""
    dk = 128 if hd <= 128 else MAX_HD
    n = 1024 + 2 * dk * ROWS + _STAGES * 2 * dk * _KT + 2 * 2 * ROWS * 64 \
        + 2 * 4 * ROWS + 8 * (2 + 2 * _STAGES)
    if codes:
        n += dk * _KT + _STAGES * 4 * _KT
    return n


def loads_by_tma(q: torch.Tensor, kx, kc: torch.Tensor,
                 page_size=None) -> bool:
    """Whether a launch loads q, the chunk's keys (``kx``, None at decode)
    and the cache by TMA (the library's ``pmt_latent_tma``):
    16-byte-aligned bases, rows a whole number of 16-byte units (bf16 and
    cache rows), and page boxes of gcd(page_size, 16) >= 8 rows.
    Otherwise its loading warp copies them element by element."""
    hd = q.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, kx, kc)
                  if t is not None)
    return (aligned and 2 * hd % 16 == 0 and kc.element_size() * hd % 16 == 0
            and (page_size is None or math.gcd(page_size, 16) >= 8))


def launch(q: torch.Tensor, kx, kc: torch.Tensor, k_scale, pos: torch.Tensor,
           page_table, *, hdv: int, scale: float, decode: bool
           ) -> torch.Tensor:
    """Launch the kernel over a decode step or a prefill chunk.  q: (B,
    KVH, T, G, hd) bf16 (T = 1 with ``decode``); kx: the chunk's keys (B,
    T, KVH, hd) bf16, None with ``decode``; kc: the cache (B, C, KVH, hd)
    or, with a page table (B, NB) int32, the pools (P, ps, KVH, hd);
    k_scale: the codes' (rows, KVH) float32 scales; pos: (B,) int32 lens
    (decode) or chunk offsets.  All on the card and contiguous, checked
    by the caller.  Returns (B, KVH, T, G, hdv) bf16."""
    b, kvh, t, g, hd = q.shape
    if page_table is None:
        c, nb, ps = kc.shape[1], 1, kc.shape[1]
    else:
        nb, ps = page_table.shape[1], kc.shape[1]
        c = nb * ps
    dev = q.device
    out = torch.empty((b, kvh, t, g, hdv), dtype=q.dtype, device=dev)
    codes = k_scale is not None
    err = build.library().pmt_latent_attention(
        q.data_ptr(), None if kx is None else kx.data_ptr(), kc.data_ptr(),
        k_scale.data_ptr() if codes else None, pos.data_ptr(),
        None if page_table is None else page_table.data_ptr(),
        out.data_ptr(), b, t, c, nb, ps, kc.shape[0], kvh, g, hd, hdv,
        float(scale), int(decode), int(page_table is not None),
        build.dtype_code(kc.dtype, codes=codes), split_kv.sm_count(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "latent_attention")
    return out
