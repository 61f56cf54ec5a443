"""The latent-attention launcher's plan for the decode step on the CPU
(``kernels/latent_attention.py``): row blocks and splits at rows 3v's
and 7v's served shapes (B8 over 128 heads: 16 clusters of 8 splits, one
wave on 132 SMs) and at small G, what a split keeps in shared memory for
the cluster's fold in place of a workspace in device memory, and the
kernel's shared memory at every width tier and cache dtype within a
block's 232,448 bytes.  ``tests/test_torch_latent_decode_cuda.py`` holds
these formulas to the C library's on the card.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import latent_attention as la  # noqa: E402
from repro_torch.kernels import split_kv  # noqa: E402

SMEM_LIMIT = 232_448  # dynamic shared memory a block can have on the H100
SMS = 132


@pytest.mark.parametrize("shape, groups, splits", [
    # rows 3v and 7v: B8 G128 over a 1024-slot cache or 64 pages of 16
    ((8, 1, 128, 1024), 16, 8),
    # one request: 2 row blocks, the most splits
    ((1, 1, 128, 1024), 2, 8),
    # a short cache caps the splits at one a 64 keys
    ((8, 1, 128, 200), 16, 4),
    ((8, 1, 128, 64), 16, 1),
    # a large batch fills the SMs with fewer splits: 64 groups, 2 each
    ((32, 1, 128, 1024), 64, 2),
    ((96, 1, 128, 1024), 192, 1),
    # small G: one row block a row
    ((3, 1, 3, 100), 3, 2),
    ((3, 1, 4, 96), 3, 2),
    ((8, 1, 4, 1024), 8, 8),
    ((2, 3, 4, 16), 6, 1),
])
def test_decode_blocks_and_splits(shape, groups, splits):
    b, kvh, g, c = shape
    assert la.decode_groups(b, kvh, g) == groups
    assert la.decode_split_count(groups, c, SMS) == splits


@pytest.mark.parametrize("b, nb, ps", [(8, 64, 16), (8, 128, 8),
                                       (8, 256, 4)])
def test_decode_one_wave_at_the_served_shape(b, nb, ps):
    # 3v and 7v alike: the capacity of the pages is the cache's, 1024
    groups = la.decode_groups(b, 1, 128)
    nsplit = la.decode_split_count(groups, nb * ps, SMS)
    assert groups * nsplit == 128 <= SMS
    assert nsplit <= la.MAX_SPLITS  # a portable cluster


@pytest.mark.parametrize("c", [1, 63, 64, 65, 127, 1024, 4096])
def test_decode_splits_cover_the_range(c):
    # every key of the longest row lies in exactly one split, in order
    nsplit = la.decode_split_count(la.decode_groups(1, 1, 128), c, SMS)
    bounds = [split_kv.split_range(0, c, nsplit, s) for s in range(nsplit)]
    assert bounds[0][0] == 0 and bounds[-1][1] == c
    for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
        assert lo <= hi == lo2
    # a row with no key (lens -1) leaves every split empty
    assert all(split_kv.split_range(0, 0, nsplit, s) == (0, 0)
               for s in range(nsplit))


def test_decode_workspace_in_shared_memory():
    # no workspace in device memory: a split keeps its 64 x hdv fp32
    # partial in its q and ring, the cluster's fold its weights in p's
    # buffers; 16 groups x 8 splits x 64 x 514 floats would have been
    # 16.8 MB
    groups = la.decode_groups(8, 1, 128)
    nsplit = la.decode_split_count(groups, 1024, SMS)
    assert groups * nsplit * la.ROWS * (512 + 2) * 4 == 16_842_752
    for dk, dv in ((128, 128), (576, 512)):
        assert la.ROWS * dv * 4 <= la.ROWS * dk * 2 + 3 * 32 * dk * 2
    assert la.MAX_SPLITS * la.ROWS * 4 <= 2 * la.ROWS * 128


@pytest.mark.parametrize("hd", [1, 24, 36, 64, 72, 128, 129, 320, 576])
@pytest.mark.parametrize("codes", [False, True])
def test_decode_smem_fits_a_block(hd, codes):
    # the decode step runs the prefill chunk's kernel: one layout
    n = la.smem_bytes(hd, codes)
    assert n <= SMEM_LIMIT
    # with the fold's row maxima and sums and the rank table, 540 bytes
    # of static shared memory
    assert n + 540 <= SMEM_LIMIT
    assert n % 8 == 0  # the barriers' alignment


@pytest.mark.parametrize("g", [3, 4, 64, 65, 128])
def test_decode_row_blocks_pack_heads(g):
    assert la.decode_groups(1, 1, g) == math.ceil(g / la.ROWS)
    assert la.decode_groups(5, 2, g) == 10 * math.ceil(g / la.ROWS)
