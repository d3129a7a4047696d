"""The 3xTF32 GEMM's Hopper kernel (`csrc/gemm_3xtf32.cu`,
`gemm_3xtf32_wgmma_kernel`) on the CPU: the route rule of
`nngp_tpu_torch.ops.matmul`, and a model of the kernel's shared-memory maps.

The kernel runs only on the card, where `chip_smoke.py` phase 17 holds it to
fp64, its plain twin and torch.matmul fp32 on both routes. What decides and
shapes its launches is plain Python or plain index arithmetic, held here:

  - `tma_stride` / `launch_plan`: which kernel takes a product (the wgmma
    route for outputs wider than 16 columns, whatever the operands' row
    strides; the narrow kernel for the rest), the tile (128 x 128, or
    128 x 64 up to 64 columns), and split K when the tiles are fewer than
    the SMs, at every shape of `chip_smoke.GEMM_SHAPES` and at the serving
    buckets' predict products;
  - the shared-memory maps, modelled here from the kernel's index
    arithmetic (`kmajor_off`, `mnmajor_off`, `split_b`'s block map,
    `load_a_slice`'s fragment reads): each is a bijection onto its tile;
    each 16-byte chunk stays whole and aligned; the raw tiles are TMA's
    128-byte swizzle of their boxes and B_big / B_small the K-major layout
    that a wgmma descriptor (stride byte offset 1,024, 128-byte swizzle,
    start advanced 32 bytes a k8 slice) reads; and the bank conflicts of
    one warp's accesses: none in the split pass's 16-byte reads and stores
    (each quarter warp on 8 distinct chunks of a 128-byte row) nor in the A
    fragment reads of an operand stored M x K, two-way in those of an
    operand stored K x M (16 banks, each hit twice).
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from nngp_tpu_torch.ops import matmul as MM

SMS = 132                     # an H100 SXM's SMs
BK = 32                       # the kernel's K-step: one 128-byte row
BOX_BYTES = 32 * BK * 4       # a TMA box of 32 rows of 128 bytes
CONSUMERS = 256


# ------------------------------------------------------------ route rule
def _route(a, b, sms=SMS):
    """launch_plan's (shape, tiles, splits, k_split, blocks, bm) for a @ b, as
    `_matmul_on_route` plans it; the operands' strides do not enter (an
    operand TMA cannot address is copied into a padded buffer first)."""
    m, k = a.shape
    n = b.shape[1]
    return MM.launch_plan(m, n, k, sms)


def _aligned(rows, cols, offset=0):
    """A (rows, cols) view of a 16-byte aligned buffer, `offset` floats in."""
    buf = torch.zeros(rows * cols + 64)
    base = (-buf.data_ptr() // 4) % 4
    return buf[base + offset:base + offset + rows * cols].view(rows, cols)


def test_tma_stride_reads_base_and_strides():
    t = _aligned(12, 8)
    assert MM.tma_stride(*MM.operand_layout(t, 12, 8), 12, 8) == 8
    assert MM.tma_stride(*MM.operand_layout(t.mT, 8, 12), 8, 12) == 8
    # a column block of a wider matrix keeps its row stride
    wide = _aligned(12, 12)[:, :7]
    assert MM.tma_stride(*MM.operand_layout(wide, 12, 7), 12, 7) == 12
    # a row stride of 17 floats, or a base 4 bytes off, is not addressable
    odd = _aligned(12, 17)
    assert MM.tma_stride(*MM.operand_layout(odd, 12, 17), 12, 17) is None
    shifted = _aligned(12, 8, offset=1)
    assert MM.tma_stride(*MM.operand_layout(shifted, 12, 8), 12, 8) is None
    # one stored row: its length rounded up to 16 bytes stands in for the
    # stride it does not have
    row = _aligned(1, 13)
    assert MM.tma_stride(*MM.operand_layout(row, 1, 13), 1, 13) == 16
    col = _aligned(13, 1)
    assert MM.tma_stride(*MM.operand_layout(col, 13, 1), 13, 1) == 16
    # rows that overlap (a stride-0 broadcast) are not addressable
    bcast = _aligned(1, 8).expand(5, 8)
    assert MM.tma_stride(*MM.operand_layout(bcast, 5, 8), 5, 8) is None


@pytest.mark.parametrize("m,n,k,shape", [
    (16384, 2048, 2048, "wgmma"),
    (16384, 2050, 2050, "wgmma"),
    (65536, 64, 2112, "wgmma_n64"),
    (65536, 17, 2112, "wgmma_n64"),
    (65536, 65, 2112, "wgmma"),
    (8192, 16, 2048, "narrow"),
    (8192, 1, 2048, "narrow"),
    (100, 100, 0, "wgmma"),
])
def test_launch_plan_routes(m, n, k, shape):
    """The wgmma route takes outputs wider than NARROW_MAX_N columns, K
    empty or not and whatever the strides (128 x 64 tiles up to N64_MAX_N
    columns); the narrow kernel takes the rest."""
    got, tiles, splits, k_split, blocks, bm = MM.launch_plan(m, n, k, SMS)
    bn = MM.TILES[got][1]
    assert got == shape
    assert MM.ROUTE_OF[got] == ("wgmma" if shape.startswith("wgmma")
                                else "narrow")
    assert tiles == -(-m // bm) * (1 if shape == "narrow" else -(-n // bn))
    step = MM.narrow_stage_k(bm) if shape == "narrow" else BK
    assert k_split % step == 0 and (splits - 1) * k_split < max(k, 1) \
        <= splits * k_split
    assert blocks <= SMS


def _shape_operands(m, n, k, ta, tb):
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((k, m) if ta else (m, k), generator=gen)
    b = torch.randn((n, k) if tb else (k, n), generator=gen)
    return (a.mT if ta else a), (b.mT if tb else b)


WANT_SHAPE = {"panel psi NN": ("wgmma", 2048, 1),
              "panel C TN": ("wgmma", 256, 1),
              "tail psi NN": ("wgmma", None, 1),
              "tail C TN": ("wgmma", 256, 1),
              "panel b TN": ("narrow", 64, 2),
              "rpchol residual NT": ("wgmma_n64", 512, 1),
              "rpchol update NN": ("wgmma_n64", 512, 1),
              "predict psi NN": ("wgmma", 1024, 1),
              "predict mean NN": ("narrow", 128, 1),
              "predict h TT": ("wgmma", 1024, 1),
              "panel psi NN m=2050": ("wgmma", 2176, 1)}


@pytest.mark.parametrize("label,m,n,k,ta,tb", chip_smoke.GEMM_SHAPES,
                         ids=[s[0] for s in chip_smoke.GEMM_SHAPES])
def test_every_gemm_shape_takes_its_route(label, m, n, k, ta, tb):
    """The Nystrom tier's products (`chip_smoke.GEMM_SHAPES`, operands laid
    out as the tier lays them): the panel, tail, RPCholesky and predict
    products on the wgmma route, the one-column ones on the narrow kernel,
    128 blocks in one wave (b += psi^T y: 64 row blocks of 32, K split over
    clusters of 2; the mean: 128 row blocks of 64)."""
    a, b = _shape_operands(m, n, k, ta, tb)
    shape, tiles, splits, k_split, blocks, _ = _route(a, b)
    want_shape, want_tiles, want_splits = WANT_SHAPE[label]
    assert shape == want_shape
    if want_tiles is not None:
        assert tiles == want_tiles
    assert splits == want_splits
    if shape == "narrow":
        assert blocks == tiles * splits == 128
    assert (splits - 1) * k_split < k <= splits * k_split


@pytest.mark.parametrize("bucket", chip_smoke.GRAPH_BUCKETS)
def test_serving_buckets_take_the_wgmma_route(bucket):
    """A serving bucket's predict at m = 2,048 (rank 2,048): psi =
    K_*m W (bucket x 2,048 x 2,048, NN) and h = ic^T psi (2,048 x bucket x
    2,048, TT) on the wgmma route; when the output tiles are fewer than
    the SMs K is split, each split a whole number of K-steps, at least
    MIN_SPLIT_STEPS of them, the splits covering K."""
    m = k = 2048
    cross = torch.zeros((bucket, m))
    w_solve = torch.zeros((m, k))
    ic = torch.zeros((k, k))
    psi = torch.zeros((bucket, k)).mT
    for a, b, n in ((cross, w_solve, k), (ic.mT, psi, bucket)):
        shape, tiles, splits, k_split, _, _ = _route(a, b)
        assert shape == ("wgmma_n64" if n <= MM.N64_MAX_N else "wgmma")
        bm, bn = MM.TILES[shape]
        assert tiles == -(-a.shape[0] // bm) * -(-n // bn)
        assert (splits > 1) == (tiles < SMS)
        assert k_split % BK == 0 and (splits - 1) * k_split < k \
            <= splits * k_split
        if splits > 1:
            assert k_split >= MM.MIN_SPLIT_STEPS * BK
    # the bucket's mean (one column) takes the narrow kernel
    assert _route(psi.mT, torch.zeros((k, 1)))[0] == "narrow"


def test_a_rank_that_is_not_a_multiple_of_4_takes_the_first_design():
    """A whitening basis k = 2,047 columns wide, whose rows are not 16-byte
    multiples apart, took the first design (mma.sync) until it was
    retired: now the panel's products take the wgmma route all the same,
    the wrapper handing TMA a padded copy (`_tma_operand`) with a row
    stride of 2,048, and the tier's own buffers (`padded_empty`) need no
    copy."""
    k = 2047
    solve_pm = torch.zeros((16384, 2048))
    w_solve = torch.zeros((2048, k))
    psi = torch.zeros((16384, k))
    assert _route(solve_pm, w_solve)[0] == "wgmma"
    assert _route(psi.mT, psi)[0] == "wgmma"
    staged, trans, ld = MM._tma_operand(w_solve, 2048, k)
    assert staged is not w_solve and not trans and ld == 2048
    assert torch.equal(staged, w_solve) and staged.stride() == (2048, 1)
    laid = MM.padded_empty(16384, k)
    got, trans, ld = MM._tma_operand(laid.mT, k, 16384)
    assert got.data_ptr() == laid.data_ptr() and (trans, ld) == (True, 2048)


def test_forcing_a_route_checks_it():
    """`_matmul_on_route` takes 'wgmma', 'narrow' or None ('mma', the
    retired first design, raises); a CPU product runs the twin on any
    route."""
    a, b = torch.randn(5, 3), torch.randn(3, 4)
    want = MM.matmul_3xtf32_plain(a, b)
    for route in ("wgmma", "narrow", None):
        assert torch.equal(MM._matmul_on_route(a, b, None, 1.0, 0.0, route),
                           want)
    for route in ("cublas", "mma"):
        with pytest.raises(ValueError, match="route"):
            MM._matmul_on_route(a, b, None, 1.0, 0.0, route)


# -------------------------------------------------- shared-memory maps
def kmajor_off(r, k):
    """`kmajor_off` of the kernel: a [rows][32] tile, k contiguous."""
    return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2)


def mnmajor_off(r, k):
    """`mnmajor_off` of the kernel: r / 32 boxes of [32 k][32 r]."""
    return ((r >> 5) * BOX_BYTES + k * 128
            + (((((r & 31) >> 2) ^ k) & 7) << 4) + ((r & 3) << 2))


def swizzle128(addr):
    """The 128-byte swizzle of TMA (CU_TENSOR_MAP_SWIZZLE_128B) and of a
    wgmma descriptor's swizzle mode 1: the 16-byte chunk bits [4:6] of an
    address XORed with its 128-byte row bits [7:9] (1,024-byte aligned
    tiles)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def split_block(ctid):
    """`split_b`'s (nb, kb): the 4 x 4 block of the B tile (n 4 nb.., k
    4 kb..) that consumer thread ctid splits."""
    q = ctid & 7
    nb = (ctid >> 5) * 4 + (q & 3)
    kb = (((ctid >> 4) & 1) << 2) | ((((q >> 1) ^ (ctid >> 3)) & 1) << 1) \
        | (q >> 2)
    return nb, kb


def a_fragment(wg, warp, lane, kk, v):
    """`load_a_slice`'s (m, k): value v of lane's A fragment, k8 slice
    kk, in warpgroup wg's warp."""
    g, t = lane >> 2, lane & 3
    return 64 * wg + 16 * warp + g + 8 * (v & 1), 8 * kk + t + 4 * (v >> 1)


@pytest.mark.parametrize("rows", [128, 64])
@pytest.mark.parametrize("layout", ["kmajor", "mnmajor"])
def test_tile_maps_are_bijections_with_whole_aligned_chunks(rows, layout):
    """Every (r, k) of a rows x 32 tile lands on its own 4-byte slot of the
    tile's rows * 128 bytes, and the 4 elements of each 16-byte chunk (4
    consecutive k in the K-major map, 4 consecutive r in the other) stay
    together, in order, 16-byte aligned."""
    off = kmajor_off if layout == "kmajor" else mnmajor_off
    slots = sorted(off(r, k) for r in range(rows) for k in range(BK))
    assert slots == list(range(0, rows * BK * 4, 4))
    for r, k in itertools.product(range(rows), range(0, BK, 4)):
        if layout == "kmajor":
            chunk = [off(r, k + i) for i in range(4)]
        else:
            chunk = [off((r // 4) * 4 + i, k) for i in range(4)]
        assert chunk[0] % 16 == 0
        assert chunk == list(range(chunk[0], chunk[0] + 16, 4))


@pytest.mark.parametrize("rows", [128, 64])
def test_raw_tiles_are_tma_swizzled_boxes(rows):
    """A box {32, rows} of an operand stored with K contiguous lands as
    row-major 128-byte rows swizzled; boxes {32, 32} of an operand stored
    with M or N contiguous land one per 4 KB, k-rows swizzled: the maps the
    kernel reads are TMA's."""
    for r, k in itertools.product(range(rows), range(BK)):
        assert kmajor_off(r, k) == swizzle128(r * 128 + k * 4)
        box = (r // 32) * BOX_BYTES
        assert mnmajor_off(r, k) == box + swizzle128(k * 128 + (r % 32) * 4)


@pytest.mark.parametrize("n_cols", [128, 64])
def test_split_tiles_are_what_the_wgmma_descriptor_reads(n_cols):
    """B_big / B_small hold (n, k) at kmajor_off(n, k); a wgmma reading the
    k8 slice kk through a descriptor with start = tile + 32 kk, stride byte
    offset 1,024 (8 rows of 128 bytes) and the 128-byte swizzle fetches
    element (n, 8 kk + j) from swizzle(start + (n / 8) 1,024 + (n % 8) 128
    + 4 j): the same byte."""
    for n, kk, j in itertools.product(range(n_cols), range(4), range(8)):
        start = 32 * kk
        addr = swizzle128(start + (n // 8) * 1024 + (n % 8) * 128 + 4 * j)
        assert addr == kmajor_off(n, 8 * kk + j)


@pytest.mark.parametrize("n_cols", [128, 64])
def test_split_pass_covers_the_b_tile_once(n_cols):
    """The split pass's 4 x 4 blocks: the first n_cols * 32 / 16 consumer
    threads take one block each, every block of the n_cols x 32 tile
    exactly once (the other threads of a 64-column tile sit it out)."""
    blocks = n_cols * BK // 16
    got = sorted(split_block(c) for c in range(blocks))
    assert got == sorted(itertools.product(range(n_cols // 4), range(8)))


def _phase_chunks(addrs):
    """Chunk positions (bank groups of 4 banks) of 16-byte accesses."""
    return [(a >> 4) & 7 for a in addrs]


@pytest.mark.parametrize("n_cols", [128, 64])
def test_split_pass_accesses_are_free_of_bank_conflicts(n_cols):
    """A 16-byte access of a warp is served a quarter warp (8 lanes) at a
    time; it is free of bank conflicts when the 8 lanes touch 8 distinct
    16-byte chunks of a 128-byte row. So it is for each of the split
    pass's reads (raw B stored K x N: row k of the mnmajor map; stored N x
    K: row n of the kmajor map) and stores (kmajor)."""
    blocks = n_cols * BK // 16
    for first in range(0, min(blocks, CONSUMERS), 8):
        lanes = [split_block(c) for c in range(first, first + 8)]
        for i in range(4):
            reads_kn = [mnmajor_off(4 * nb, 4 * kb + i) for nb, kb in lanes]
            rows_nk = [kmajor_off(4 * nb + i, 4 * kb) for nb, kb in lanes]
            assert len(set(_phase_chunks(reads_kn))) == 8
            assert len(set(_phase_chunks(rows_nk))) == 8   # reads and stores


@pytest.mark.parametrize("layout,degree", [("kmajor", 1), ("mnmajor", 2)])
def test_a_fragment_reads_bank_conflict_degree(layout, degree):
    """Each 4-byte A fragment read of a warp (one (kk, v)): 32 distinct
    banks from a raw A tile stored M x K (kmajor); from one stored K x M
    (mnmajor, the panel's C += psi^T psi) 16 banks, each read by 2 lanes:
    a two-way conflict, the fragment map being fixed by wgmma."""
    off = kmajor_off if layout == "kmajor" else mnmajor_off
    for wg, warp, kk, v in itertools.product(range(2), range(4), range(4),
                                             range(4)):
        banks = [(off(*a_fragment(wg, warp, lane, kk, v)) >> 2) & 31
                 for lane in range(32)]
        counts = np.bincount(banks, minlength=32)
        assert counts.max() == degree and (counts > 0).sum() == 32 // degree


def test_a_fragments_cover_the_a_tile_once():
    """The consumers' fragment reads of one K-step cover the 128 x 32 raw A
    tile, each element read by one lane once."""
    seen = [a_fragment(wg, warp, lane, kk, v)
            for wg, warp, lane, kk, v in itertools.product(
                range(2), range(4), range(32), range(4), range(4))]
    assert sorted(seen) == sorted(itertools.product(range(128), range(BK)))
