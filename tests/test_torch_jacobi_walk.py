"""The CUDA JACOBI2D kernel's strip walk (``csrc/jacobi2d.cu``), emulated
on the CPU.

The kernel gives each thread COLS adjacent columns (4, one float4, when
W % 4 == 0 and x and out are 16-byte aligned; else 1, the element path)
and a strip of ROWS rows.  The thread loads its strip's ROWS + 2 rows
(zeros outside the grid), takes its left and right neighbours from its
own columns and, across lanes, from ``__shfl_up_sync`` /
``__shfl_down_sync`` (a lane at the warp's edge keeps its own value
there, and lane 0 and lane 31 load the column outside instead), and
stores only rows and columns inside the grid; interior cells get
``0.2f * ((((c + up) + down) + left) + right)`` in float32, the others
keep x.  Here that walk is written out in plain torch, thread by thread
as tensors over the threads of the grid, with the kernel's THREADS and
ROWS read from its source, and held bit for bit to the JAX
``jacobi2d_ref`` at heights and widths on the edges of the strips,
float4 lanes and warps, on both paths.  The ``cuda`` tests hold the
kernel itself to the plain version at the same shapes.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.jacobi2d import jacobi2d_ref as jax_jacobi2d_ref  # noqa: E402
from repro_torch.kernels.jacobi2d import kernel as jac_kernel  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "jacobi2d.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, ROWS = _constant("THREADS"), _constant("ROWS")
FIFTH = torch.tensor(0.2, dtype=torch.float32)     # the kernel's 0.2f


def _shfl(v: torch.Tensor, delta: int) -> torch.Tensor:
    """__shfl_up_sync (delta 1) or __shfl_down_sync (delta -1) by one lane
    over (threads,) values, warps of 32: a lane with no source keeps its
    own value."""
    w = v.reshape(-1, 32)
    if delta == 1:
        return torch.cat([w[:, :1], w[:, :-1]], dim=1).reshape(-1)
    return torch.cat([w[:, 1:], w[:, -1:]], dim=1).reshape(-1)


def emulated_jacobi2d(x: torch.Tensor, vec16: bool,
                      edge_loads: bool = True) -> torch.Tensor:
    """The kernel's sweep of (H, W) float32 ``x``; ``vec16``: x and out
    16-byte aligned (the 16-byte path when W % 4 == 0 too).
    ``edge_loads=False`` drops lane 0's and lane 31's loads of the column
    outside their warp (a broken walk, for the test that shows it
    matters)."""
    h, w = x.shape
    cols = 4 if vec16 and w % 4 == 0 else 1
    blocks_x = -(-w // (THREADS * cols))
    n = blocks_x * THREADS                       # threads across the grid
    c0 = torch.arange(n) * cols                  # each thread's first column
    lane = torch.arange(n) % 32
    inside = c0 < w
    ce = torch.where(lane == 0, c0 - 1, c0 + cols)
    edge = ((lane == 0) | (lane == 31)) & (ce >= 0) & (ce < w) & edge_loads
    padded = torch.zeros(h, n * cols)
    padded[:, :w] = x                            # loads outside W: zeros
    out = torch.full_like(x, float("nan"))       # every cell is stored
    for y0 in range(0, h, ROWS):
        r = torch.zeros(ROWS + 2, n, cols)       # rows y0 - 1 .. y0 + ROWS
        for i in range(ROWS + 2):
            if 0 <= y0 - 1 + i < h:
                r[i] = padded[y0 - 1 + i].reshape(n, cols)
        e = torch.zeros(ROWS, n)                 # the warp-edge columns
        for i in range(min(ROWS, h - y0)):
            e[i, edge] = x[y0 + i, ce[edge]]
        for i in range(ROWS):
            y = y0 + i
            c = r[i + 1]
            from_left = _shfl(c[:, cols - 1], 1)
            from_right = _shfl(c[:, 0], -1)
            if y >= h:
                continue
            o = c.clone()
            if 0 < y < h - 1:
                for j in range(cols):
                    col = c0 + j
                    left = c[:, j - 1] if j > 0 else torch.where(
                        lane == 0, e[i], from_left)
                    right = c[:, j + 1] if j < cols - 1 else torch.where(
                        lane == 31, e[i], from_right)
                    val = FIFTH * ((((c[:, j] + r[i][:, j]) + r[i + 2][:, j])
                                    + left) + right)
                    o[:, j] = torch.where((col > 0) & (col < w - 1), val,
                                          o[:, j])
            out[y] = o[inside].reshape(-1)[:w]
    return out


def _input(h: int, w: int) -> np.ndarray:
    return np.random.default_rng(h * 1000 + w).standard_normal(
        (h, w)).astype(np.float32)


def _jax(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax_jacobi2d_ref(jnp.asarray(x)))


HEIGHTS = sorted({1, 2, 3, 5, ROWS - 1, ROWS, ROWS + 1, 2 * ROWS + 1})
WIDTHS = sorted(set(HEIGHTS) | {127, 128, 129, 513})
SHAPES = [(h, w) for h in HEIGHTS for w in WIDTHS] + [
    (2 * ROWS + 3, 4 * THREADS + 4), (ROWS + 1, 4 * THREADS - 4)]


@functools.lru_cache(maxsize=None)
def _jax_at_shapes() -> dict:
    """The JAX reference of every shape's input, all under one jit (one
    compile, where the eager ops compile once a shape each; its bits are
    the eager reference's)."""
    xs = [_input(h, w) for h, w in SHAPES]
    outs = jax.jit(lambda xs: [jax_jacobi2d_ref(x) for x in xs])(xs)
    return {shape: np.asarray(o) for shape, o in zip(SHAPES, outs)}


def _check(h: int, w: int, vec16: bool) -> None:
    got = emulated_jacobi2d(torch.from_numpy(_input(h, w)), vec16).numpy()
    np.testing.assert_array_equal(got, _jax_at_shapes()[(h, w)])


def test_one_jit_is_the_eager_reference():
    for shape in [(ROWS + 1, 129), (2 * ROWS + 1, 513), (1, 1)]:
        np.testing.assert_array_equal(_jax_at_shapes()[shape],
                                      _jax(_input(*shape)))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("h", HEIGHTS)
def test_emulated_walk_matches_jax_exactly(h, w):
    """Both paths: x aligned (the 16-byte path where W % 4 == 0) and one
    element into its storage (the element path)."""
    _check(h, w, vec16=True)
    _check(h, w, vec16=False)


@pytest.mark.parametrize("shape", SHAPES[-2:])
def test_emulated_walk_across_blocks_matches_jax_exactly(shape):
    """Widths past one block of THREADS x 4 columns (a block whose first
    warp's lane 0 loads the previous block's last column) and heights
    past two strips."""
    _check(*shape, vec16=True)


def test_walk_reads_the_kernels_constants():
    """The emulation's THREADS and ROWS are the kernel source's, and the
    wrapper bounds H by the same ROWS (gridDim.y's 65535 strips) and W by
    a block's 16-byte-path columns."""
    assert (THREADS, ROWS) == (128, jac_kernel.ROWS)
    assert jac_kernel.BLOCK_COLUMNS == THREADS * 4


@pytest.mark.parametrize("vec16", [True, False])
def test_walk_without_edge_loads_misses(vec16):
    """The warp-edge loads matter: without lane 0's and lane 31's loads of
    the column outside their warp, the walk misses the reference at every
    interior warp boundary (columns 127 | 128 on the 16-byte path, 31 |
    32 on the element path), and only there."""
    x = np.random.default_rng(0).standard_normal((5, 260)).astype(
        np.float32)
    got = emulated_jacobi2d(torch.from_numpy(x), vec16,
                            edge_loads=False).numpy()
    bad = sorted(set(np.nonzero(got != _jax(x))[1].tolist()))
    warp = 128 if vec16 else 32
    assert bad == [c for k in range(1, 260 // warp + 1)
                   for c in (k * warp - 1, k * warp) if k * warp < 259]
