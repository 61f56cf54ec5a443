"""Constants shared across the kernel families and their model callers.

``NEG_INF`` is the additive logit mask used by every attention path.  It
is a large finite value rather than ``-inf``: ``exp(NEG_INF - m)``
underflows to exactly 0.0 in fp32 for any realistic running max ``m``,
so a fully masked score contributes nothing to an online-softmax
accumulator, while ``-inf`` would poison it with NaNs through
``-inf - (-inf)``.  The CUDA sources use the same value
(``csrc/common.cuh``).
"""
import math

NEG_INF = -2.0 ** 30

# Default KV tiling of the plain blockwise versions (``ref.py``); the
# CUDA kernels pick their own tiles.  ``pick_block_k`` degrades it to a
# divisor of odd cache sizes.
DEFAULT_BLOCK_K = 128


def pick_block_k(cache_size: int, block_k: int) -> int:
    """A divisor of ``cache_size`` no bigger than ``block_k`` (their gcd).

    Cache sizes are normally powers of two, so this returns ``block_k``
    itself; odd sizes degrade to a smaller split instead of padding."""
    return math.gcd(min(block_k, cache_size), cache_size)
