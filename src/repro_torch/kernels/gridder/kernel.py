"""Wrappers of the CUDA GRIDDER and DEGRIDDER (``csrc/gridder.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Launches of each kernel since its count was last set to 0.
gridder_launches = 0
degridder_launches = 0

_MAX_TILES = 65535 * 256      # gridDim.y limit times the block's threads


def _check(name: str, lm: torch.Tensor, uv: torch.Tensor,
           other: torch.Tensor, other_rows: str):
    if not (lm.is_cuda and uv.is_cuda and other.is_cuda):
        raise ValueError(f"{name}_cuda takes tensors on the card")
    for t in (lm, uv, other):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}_cuda takes contiguous float32 "
                             f"tensors, got {t.dtype}")
    if lm.dim() != 2 or lm.shape[1] != 2 or uv.dim() != 3 \
            or uv.shape[2] != 2:
        raise ValueError(f"need lm (P, 2) and uv (S, V, 2), got "
                         f"{tuple(lm.shape)} and {tuple(uv.shape)}")
    (s, v, _), p = uv.shape, lm.shape[0]
    want = (s, v if other_rows == "V" else p, 2)
    if tuple(other.shape) != want:
        raise ValueError(f"{name}_cuda: need a {want} array beside uv "
                         f"{tuple(uv.shape)}, got {tuple(other.shape)}")
    if max(s, p, v) >= 2 ** 31:
        raise ValueError(f"shape {(s, p, v)} is beyond the kernel's grid")
    return s, p, v


def gridder_cuda(lm: torch.Tensor, uv: torch.Tensor,
                 vis: torch.Tensor) -> torch.Tensor:
    """lm (P, 2), uv (S, V, 2), vis (S, V, 2): contiguous float32 on the
    card.  Returns new subgrids (S, P, 2)."""
    global gridder_launches
    s, p, v = _check("gridder", lm, uv, vis, "V")
    if p > _MAX_TILES:
        raise ValueError(f"P = {p} is beyond the kernel's grid")
    out = torch.empty((s, p, 2), dtype=torch.float32, device=lm.device)
    err = build.library().pmt_gridder(
        lm.data_ptr(), uv.data_ptr(), vis.data_ptr(), out.data_ptr(), s, p,
        v, torch.cuda.current_stream().cuda_stream)
    build.check(err, "gridder")
    gridder_launches += 1
    return out


def degridder_cuda(lm: torch.Tensor, uv: torch.Tensor,
                   subgrids: torch.Tensor) -> torch.Tensor:
    """lm (P, 2), uv (S, V, 2), subgrids (S, P, 2): contiguous float32 on
    the card.  Returns new visibilities (S, V, 2)."""
    global degridder_launches
    s, p, v = _check("degridder", lm, uv, subgrids, "P")
    if v > _MAX_TILES:
        raise ValueError(f"V = {v} is beyond the kernel's grid")
    out = torch.empty((s, v, 2), dtype=torch.float32, device=lm.device)
    err = build.library().pmt_degridder(
        lm.data_ptr(), uv.data_ptr(), subgrids.data_ptr(), out.data_ptr(),
        s, p, v, torch.cuda.current_stream().cuda_stream)
    build.check(err, "degridder")
    degridder_launches += 1
    return out
