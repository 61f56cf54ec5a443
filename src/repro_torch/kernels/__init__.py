"""Kernel families of the port: each ``<family>/`` holds the CUDA
kernel's wrapper (``kernel.py``, source in ``csrc/``), its plain PyTorch
version (``ref.py``) and the op the models call (``ops.py``).

An op takes the plain version for tensors on the CPU and launches the
kernel for tensors on the card.  There is no other route: no fallback
when a launch fails and no switch that sends card tensors to the plain
version.
"""
from __future__ import annotations

import torch


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the card, False when every one lies
    on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on the card or all on the "
                     f"CPU, got {sorted(kinds)}")


def scale_tensors(k_scale, v_scale) -> list:
    """The row-scale tensors of a quantized cache that were given (for
    ``on_card``); ``v_scale`` alone, without ``k_scale``, raises."""
    if k_scale is None and v_scale is not None:
        raise ValueError("v_scale without k_scale")
    return [t for t in (k_scale, v_scale) if t is not None]
