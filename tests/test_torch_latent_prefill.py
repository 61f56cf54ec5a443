"""The latent-attention launcher's plan for the prefill chunk on the CPU
(``kernels/latent_attention.py``): the kernel's shared memory at every
width tier and cache dtype within a block's 232,448 bytes, its row
blocks and splits at rows 2v's and 8v's served shapes, the shape and
stride rule that picks TMA or the producer's element copies, and
``takes`` admitting exactly the inputs it admitted before the kernel was
redesigned.  ``tests/test_torch_latent_decode.py`` has the decode's
plan; ``tests/test_torch_latent_prefill_cuda.py`` and
``tests/test_torch_latent_decode_cuda.py`` hold these formulas to the C
library's on the card.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import latent_attention as la  # noqa: E402

SMEM_LIMIT = 232_448  # dynamic shared memory a block can have on the H100


@pytest.mark.parametrize("hd", [1, 24, 64, 72, 128, 129, 320, 576])
@pytest.mark.parametrize("codes", [False, True])
def test_prefill_smem_fits_a_block(hd, codes):
    n = la.smem_bytes(hd, codes)
    dk = 128 if hd <= 128 else 576
    # q, the ring of three key tiles and p_hi | p_lo at least
    assert 64 * dk * 2 + 3 * 32 * dk * 2 + 64 * 128 < n
    assert n <= SMEM_LIMIT


def test_prefill_smem_at_full_width():
    # 576 wide: q 73,728 + three 36,864-byte tiles + two p buffers of
    # 8,192 + row maxima 512 + barriers 64 + 1 KB of alignment slack; over
    # codes also an 18,432-byte code tile and three stages' 128 bytes of
    # row scales
    assert la.smem_bytes(576, False) == 202_304
    assert la.smem_bytes(576, True) == 221_120


@pytest.mark.parametrize("shape, groups, splits", [
    # row 2v: B1 T32 G128 over a 1024-slot cache: 64 row blocks, 2 splits
    ((1, 1, 32, 128, 1024), 64, 2),
    # row 8v: B8 T32 G128 over 64 pages of 16: 512 row blocks, 1 split
    ((8, 1, 32, 128, 1024), 512, 1),
    # one decode-sized chunk of one row: 2 row blocks, the most splits
    ((1, 1, 1, 128, 1024), 2, 8),
    # a short cache caps the splits at one a 128 keys
    ((1, 1, 1, 128, 200), 2, 2),
    # small G packs several tokens a block: 27 rows, one block
    ((1, 1, 9, 3, 96), 1, 1),
    ((3, 1, 80, 4, 64), 15, 1),
])
def test_prefill_blocks_and_splits(shape, groups, splits):
    b, kvh, t, g, c = shape
    assert la.prefill_groups(b, kvh, t, g) == groups
    assert la.prefill_split_count(groups, c, 132) == splits


def _tensors(hd, cache_dtype, shift=0):
    flat = torch.empty(64 * hd + 8, dtype=torch.bfloat16)
    base = (-flat.data_ptr() // 2) % 8  # elements to a 16-byte boundary
    q = flat[base + shift:base + shift + 64 * hd].view(1, 1, 1, 64, hd)
    kx = torch.empty(1, 1, 1, hd, dtype=torch.bfloat16)
    kc = torch.empty(1, 16, 1, hd, dtype=cache_dtype)
    return q, kx, kc


@pytest.mark.parametrize("hd, cache_dtype, shift, ps, tma", [
    (576, torch.bfloat16, 0, None, True),
    (576, torch.int8, 0, None, True),
    (576, torch.float8_e4m3fn, 0, 16, True),
    (576, torch.bfloat16, 0, 8, True),
    (576, torch.bfloat16, 0, 24, True),   # boxes of gcd(24, 16) = 8 rows
    (576, torch.bfloat16, 0, 4, False),   # boxes of 4 rows
    (576, torch.bfloat16, 0, 12, False),
    (576, torch.bfloat16, 1, None, False),  # q 2 bytes off its alignment
    (72, torch.bfloat16, 0, None, True),  # 144-byte rows
    (72, torch.int8, 0, None, False),     # 72-byte code rows
    (24, torch.bfloat16, 0, 16, True),
    (24, torch.int8, 0, 16, False),
    (32, torch.int8, 0, 16, True),
    (36, torch.bfloat16, 0, None, False),  # 72-byte rows
])
def test_loads_by_tma(hd, cache_dtype, shift, ps, tma):
    q, kx, kc = _tensors(hd, cache_dtype, shift)
    assert la.loads_by_tma(q, kx, kc, ps) is tma


def _takes_before(q, k, v, v_width, k_scale, v_scale, ring, window,
                  softcap):
    """``takes`` as the first latent kernel's launcher wrote it."""
    hd = k.shape[-1]
    return (v_width is not None and q.dtype == torch.bfloat16
            and k.dtype in (torch.bfloat16, torch.int8,
                            torch.float8_e4m3fn)
            and la.aliased(k, v)
            and (v_scale is None or la.aliased(k_scale, v_scale))
            and not ring and window is None and softcap is None
            and hd <= 576 and 0 < v_width <= min(hd, 512))


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32,
                                         torch.int8, torch.float8_e4m3fn,
                                         torch.float16])
@pytest.mark.parametrize("hd, v_width", [(576, 512), (576, 513), (577, 512),
                                         (24, 16), (24, 24), (24, 25),
                                         (36, None), (72, 0)])
def test_takes_admits_what_it_admitted(q_dtype, cache_dtype, hd, v_width):
    q = torch.zeros(1, 1, 2, 3, hd, dtype=q_dtype)
    k = torch.zeros(1, 8, 1, hd, dtype=cache_dtype)
    other = torch.zeros(1, 8, 1, hd, dtype=cache_dtype)
    ks = torch.ones(1, 8, 1)
    for v, k_scale, v_scale in ((k, None, None), (other, None, None),
                                (k, ks, None), (k, ks, ks),
                                (k, ks, ks.clone())):
        for ring, window, softcap in ((False, None, None),
                                      (True, None, None), (False, 8, None),
                                      (False, None, 30.0)):
            kw = dict(ring=ring, window=window, softcap=softcap)
            assert la.takes(q, k, v, v_width, k_scale, v_scale, **kw) == \
                _takes_before(q, k, v, v_width, k_scale, v_scale, **kw)


def test_prefill_workspace_rows():
    # no workspace in device memory: a split's partial, 64 rows of hdv
    # floats, stays in its block's q and ring for the cluster's fold (row
    # 2v: 64 clusters of 2), the fold's weights in p's two buffers
    groups = la.prefill_groups(1, 1, 32, 128)
    nsplit = la.prefill_split_count(groups, 1024, 132)
    assert (groups, nsplit) == (64, 2)
    for dk, dv in ((128, 128), (576, 512)):
        assert la.ROWS * dv * 4 <= la.ROWS * dk * 2 + 3 * 32 * dk * 2
    assert la.MAX_SPLITS * la.ROWS * 4 <= 2 * la.ROWS * 128
    assert math.ceil(32 * 128 / la.ROWS) == groups
