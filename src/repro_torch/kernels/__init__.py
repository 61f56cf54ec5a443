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


def refuse_later_slices(v_width, k_scale, v_scale) -> None:
    """Raise for the attention options of later slices of the port:
    ``v_width`` (MLA's aliased latent cache) and ``k_scale``/``v_scale``
    (quantized caches)."""
    if v_width is not None:
        raise NotImplementedError("v_width comes with the MLA slice")
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "k_scale/v_scale come with the quantized-cache slice")
