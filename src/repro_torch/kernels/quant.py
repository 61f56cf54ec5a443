"""Per-row KV-cache quantization (int8 / fp8_e4m3), shared by the
cache_update, decode_attention and prefill_attention families.

The port's own copy of the JAX package's ``kernels/quant.py``.  Cache
rows are stored as low-bit codes plus one float32 absmax scale per row,
a row being one (token, kv head) head-dim vector.  In the paged layout
the scale pools page exactly like their code pools (same page ids, same
page tables), so a page's scales travel with it through prefix sharing.

Scheme (absmax, symmetric, no zero point):

    amax  = max(|x|, axis=-1)                          # per row
    scale = max(amax, SCALE_EPS) * (1 / QMAX)          # float32
    codes = cast(clip(round*(x / scale), -QMAX, QMAX)) # *int8 only
    dequant(codes, scale) = f32(codes) * scale

fp8_e4m3 clips before the cast: an out-of-range float32 cast to
float8_e4m3fn gives NaN (the format has no inf), not a saturated value.

Bit-exactness contract: the scale is a multiply by the float32 constant
``1 / QMAX``, never a division by ``QMAX``; int8 rounds half to even;
every consumer dequantizes as ``codes.float() * scale[..., None]``.  The
CUDA kernels follow the same order, so the quantizing scatters equal
their plain versions bit for bit, and every dequantized block is the
same float32 value on either side.

Gaps of PyTorch's CPU kernels for ``float8_e4m3fn``: no ``index_copy_``,
``gather``/``take_along_dim`` or ``torch.equal``.  Indexed assignment,
indexed reads, ``torch.where``, ``clone``, ``cat`` and ``.float()``
work, and the plain versions use only those; compare codes through
``.view(torch.uint8)``.
"""
from __future__ import annotations

import torch

# Supported ``ModelConfig.kv_quant`` / ``ServeEngine(cache_dtype=...)``
# modes.  qmax 127: the symmetric int8 range; qmax 448: the largest
# finite float8_e4m3fn magnitude.
QUANT_MODES = ("int8", "fp8_e4m3")
SCALE_EPS = 1e-8

_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}
_DTYPE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}
CODE_DTYPES = tuple(_DTYPE.values())


def check_mode(mode: str) -> str:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown kv quant mode {mode!r} "
                         f"(expected one of {QUANT_MODES})")
    return mode


def quant_dtype(mode: str) -> torch.dtype:
    """Storage dtype of the code leaves for ``mode``."""
    return _DTYPE[check_mode(mode)]


def qmax(mode: str) -> float:
    return _QMAX[check_mode(mode)]


def qmax_inv(mode: str) -> float:
    """``1 / qmax`` as a Python (double) constant; scales multiply by it
    (as float32) instead of dividing by ``qmax``."""
    return 1.0 / _QMAX[check_mode(mode)]


def quantize(x: torch.Tensor, mode: str):
    """Per-row absmax quantization over the last axis.

    Returns ``(codes, scales)``: codes with ``x.shape`` in the mode's
    storage dtype, scales float32 with ``x.shape[:-1]``.
    """
    qm = qmax(mode)
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scales = torch.clamp(amax, min=SCALE_EPS) * qmax_inv(mode)
    y = xf / scales[..., None]
    if mode == "int8":
        y = torch.round(y)              # half to even, as jnp.round
    codes = torch.clamp(y, -qm, qm).to(_DTYPE[mode])
    return codes, scales


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize` (up to rounding): float32 rows, in the
    op order every kernel and plain version uses."""
    return codes.float() * scales[..., None].float()
