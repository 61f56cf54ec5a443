"""What the split-KV kernels share on the host: the split count and the
shares of a key range, and the tickets with which the last block of a
group to arrive finds that it folds the splits' partials.

Two kernels split the keys over blocks this way: the bf16 chunked
prefill (``csrc/prefill_attention.cu`` ``tc::prefill_tc_kernel``) and
flash-decode (``csrc/decode_attention.cu``).  Each takes its own limits
(``prefill_attention/kernel.py`` and ``decode_attention/kernel.py``
``split_count``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# Tickets, int32 zeros, by (device, stream): each launch leaves its own
# at 0, and launches on one stream run one after another, so every
# split-KV kernel on a stream shares one array.  A grown array replaces
# the old one, which is kept, as a CUDA graph may have captured its
# address.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
_retired_tickets = []
_sms: Dict[int, int] = {}


def split_count(groups: int, c: int, sms: int, keys_per_split: int,
                max_splits: int) -> int:
    """Splits of a key range for ``groups`` blocks' worth of work over a
    cache of capacity ``c``: enough for two blocks on each of the ``sms``
    SMs, no more than one per ``keys_per_split`` keys of the capacity
    (each row's own range lies on the card, so the host sizes by the
    capacity), at most ``max_splits``: the last block folds every
    split's partial, so each split past a few costs more than it
    saves."""
    return max(1, min(math.ceil(2 * sms / groups),
                      math.ceil(c / keys_per_split), max_splits))


def split_range(start: int, limit: int, nsplit: int, s: int) -> tuple:
    """Split ``s``'s keys [lo, hi) of the range [start, limit): shares of
    ceil(n / nsplit) rounded up to 16 keys, so the last splits may be
    empty (the kernels' ``split_range``)."""
    n = limit - start
    if n <= 0:
        return 0, 0
    per = ((n + nsplit - 1) // nsplit + 15) // 16 * 16
    lo = min(start + s * per, limit)
    return lo, min(lo + per, limit)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device``."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def tickets(device: torch.device, n: int) -> Tuple[torch.Tensor, int]:
    """At least ``n`` zeroed int32 tickets for a launch on the current
    stream of ``device``, and that stream's handle."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        if t is not None:
            _retired_tickets.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t, stream
