"""repro_torch — the PyTorch/CUDA port of the PMT reproduction.

It sits beside the JAX package ``repro`` (the reference, left as it is)
and imports nothing of it and nothing of JAX.  This slice serves
smollm-135m through the continuous-batching engine with chunked
prefill; its three hot-path kernels (per-row KV scatter, chunked-prefill
attention, length-aware decode attention) are CUDA C++ written for
Hopper (``kernels/csrc``), each beside a plain PyTorch version.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``, which runs the plain versions.  Without a card and
without ``device="cpu"`` they raise: nothing falls back quietly.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
