"""The port's kernel layer against the JAX package's oracles.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held to
``repro.kernels.ref`` on the same numpy inputs, at ragged shapes with
thresholds placed exactly on data values: errors and margins within
rtol/atol 1e-5 (summation order only), fingerprint lanes bit for bit.
``flash_attention`` is held to ``repro.kernels.ref`` and to the Pallas
kernel in interpret mode at the JAX package's 2e-4 (3e-2 in bf16); its
f32 route's split-TF32 products are emulated here in torch and held to
an f64 reference at 2e-4.
The CUDA kernels are held to the plain versions on the card
(``-m cuda``); those tests need neither JAX nor the JAX package, so they
run on a machine that has only PyTorch.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def scan_case(seed, N, F, T):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, F).astype(np.float32)
    y = np.where(rng.rand(N) < 0.4, 1.0, -1.0).astype(np.float32)
    w = rng.rand(N).astype(np.float32)
    w /= w.sum()
    # every threshold is one of its feature's data values (strict `>` edge)
    thr = x[rng.randint(0, N, size=(F, T)), np.arange(F)[:, None]]
    return x, y, w, np.ascontiguousarray(thr, np.float32)


def vote_case(seed, B, T, N, pad_t):
    rng = np.random.RandomState(seed)
    xsel = rng.randn(B, T, N).astype(np.float32)
    thr = rng.randn(B, T).astype(np.float32)
    xsel[:, ::3, ::2] = thr[:, ::3, None]           # x == thr: sign tiebreak
    pol = np.where(rng.rand(B, T) < 0.5, 1.0, -1.0).astype(np.float32)
    alphas = rng.rand(B, T).astype(np.float32)
    if pad_t:
        alphas[:, -pad_t:] = 0.0                    # the batch's T padding
    return xsel, thr, pol, alphas


def batched_scan_case(seed, B, N, F, T):
    """A stacked fleet batch with zero-weight rows and a zero-weight slot,
    thresholds on data values."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, F).astype(np.float32)
    y = np.where(rng.rand(B, N) < 0.4, 1.0, -1.0).astype(np.float32)
    w = rng.rand(B, N).astype(np.float32)
    w[:, 1::3] = 0.0                                # padding rows
    w[B // 2] = 0.0                                 # a padding slot
    rows = rng.randint(0, N, size=(B, F, T))
    thr = np.take_along_axis(x.transpose(0, 2, 1), rows, axis=2)
    return x, y, w, np.ascontiguousarray(thr, np.float32)


def f64_scan_oracle(x, y, w, thr):
    """err[b,f,t] summed in f64 by numpy and rounded once to f32."""
    pred = np.where(x[:, :, :, None] > thr[:, None], 1.0, -1.0)
    miss = pred != y[:, :, None, None]
    return np.einsum("bn,bnft->bft", w.astype(np.float64),
                     miss.astype(np.float64)).astype(np.float32)


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture
def jax_ref():
    """(jax.numpy, repro.kernels.ref), imported only by the parity tests."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    return jnp, jref


@pytest.mark.parametrize("N,F,T", [(1, 1, 1), (37, 5, 3), (333, 64, 16),
                                   (517, 13, 21)])
def test_stump_scan_ref_matches_jax(jax_ref, N, F, T):
    jnp, jref = jax_ref
    args = scan_case(N + F + T, N, F, T)
    want = np.asarray(jref.stump_scan_ref(*map(jnp.asarray, args)))
    got = ref.stump_scan_ref(*t(*args)).numpy()
    assert got.shape == (F, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("N", [1, 3, 4, 37])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_stump_scan_batched_ref_matches_jax_and_f64(jax_ref, B, N):
    jnp, jref = jax_ref
    import jax
    jscan = jax.jit(jref.stump_scan_batched_ref)
    for F in (1, 5, 48):
        for T in (1, 16):
            args = batched_scan_case(B * 1000 + N * 10 + F + T, B, N, F, T)
            got = ref.stump_scan_batched_ref(*t(*args)).numpy()
            assert got.shape == (B, F, T) and got.dtype == np.float32
            # the JAX package sums in f32: equal up to its rounding
            want = np.asarray(jscan(*map(jnp.asarray, args)))
            np.testing.assert_allclose(got, want, **TOL)
            # the exact sum rounded once, whatever the order
            np.testing.assert_array_equal(got, f64_scan_oracle(*args))
            assert not got[B // 2].any()             # the zero-weight slot


def test_stump_scan_batched_ref_is_stump_scan_per_slot():
    args = batched_scan_case(7, 5, 37, 6, 16)
    got = ref.stump_scan_batched_ref(*t(*args))
    for b in range(5):
        one = ref.stump_scan_ref(*t(*(a[b] for a in args)))
        assert torch.equal(got[b], one)


@pytest.mark.parametrize("B,T,N,pad", [(1, 1, 1, 0), (2, 7, 5, 2),
                                       (3, 300, 64, 20), (2, 33, 129, 0)])
def test_stump_vote_refs_match_jax(jax_ref, B, T, N, pad):
    jnp, jref = jax_ref
    args = vote_case(B * T + N, B, T, N, pad)
    jargs = list(map(jnp.asarray, args))
    want = np.asarray(jref.stump_vote_batched_ref(*jargs))
    np.testing.assert_allclose(ref.stump_vote_batched_ref(*t(*args)).numpy(),
                               want, **TOL)
    wm, w0, w1 = (np.asarray(a) for a in jref.stump_vote_fp_batched_ref(*jargs))
    gm, g0, g1 = (a.numpy() for a in ref.stump_vote_fp_batched_ref(*t(*args)))
    np.testing.assert_allclose(gm, wm, **TOL)
    assert w0.dtype == np.uint32 and g0.dtype == np.int32
    np.testing.assert_array_equal(g0.view(np.uint32), w0)
    np.testing.assert_array_equal(g1.view(np.uint32), w1)


@pytest.mark.parametrize("N,F,T", [(37, 5, 3), (333, 64, 16)])
def test_stump_scan_ref_is_the_same_in_every_row_order(N, F, T):
    # errors that tie in exact arithmetic must tie in f32 whatever the
    # order of the sum: uniform and two-valued weights, rows permuted
    x, y, _, thr = scan_case(N, N, F, T)
    w = np.where(np.arange(N) % 3 == 0, 2.0, 1.0).astype(np.float32)
    for weights in (np.full(N, 1.0 / N, np.float32), w / w.sum()):
        want = ref.stump_scan_ref(*t(x, y, weights, thr))
        for seed in range(3):
            perm = np.random.RandomState(seed).permutation(N)
            got = ref.stump_scan_ref(*t(x[perm], y[perm], weights[perm], thr))
            assert torch.equal(got, want)


def test_fingerprint_lanes_invariant_under_zero_alpha_padding():
    xsel, thr, pol, alphas = vote_case(5, 2, 40, 17, 0)
    base = ref.stump_vote_fp_batched_ref(*t(xsel, thr, pol, alphas))
    rng = np.random.RandomState(6)
    extra = 24
    xp = np.concatenate([xsel, rng.randn(2, extra, 17).astype(np.float32)], 1)
    tp = np.concatenate([thr, rng.randn(2, extra).astype(np.float32)], 1)
    pp = np.concatenate([pol, np.ones((2, extra), np.float32)], 1)
    ap = np.concatenate([alphas, np.zeros((2, extra), np.float32)], 1)
    padded = ref.stump_vote_fp_batched_ref(*t(xp, tp, pp, ap))
    torch.testing.assert_close(padded[0], base[0], rtol=0, atol=0)
    assert torch.equal(padded[1], base[1]) and torch.equal(padded[2], base[2])


def test_cpu_tensors_take_the_plain_version_without_launching():
    ops.reset_launches()
    sargs = t(*scan_case(1, 40, 6, 5))
    bargs = t(*batched_scan_case(1, 3, 4, 6, 5))
    vargs = t(*vote_case(2, 2, 9, 11, 3))
    assert torch.equal(ops.stump_scan(*sargs), ref.stump_scan_ref(*sargs))
    assert torch.equal(ops.stump_scan_batched(*bargs),
                       ref.stump_scan_batched_ref(*bargs))
    assert torch.equal(ops.stump_vote_batched(*vargs),
                       ref.stump_vote_batched_ref(*vargs))
    for a, b in zip(ops.stump_vote_fp_batched(*vargs),
                    ref.stump_vote_fp_batched_ref(*vargs)):
        assert torch.equal(a, b)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_mixed_devices_are_refused():
    x, y, w, thr = t(*scan_case(3, 8, 2, 2))
    with pytest.raises(ValueError):
        ops.stump_scan(x, y, w, thr.to("meta"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ------------------------------------------------------------ stump scans
SCAN_SHAPES = [(1, 1, 1), (37, 5, 3), (333, 64, 16), (517, 13, 21),
               (4099, 64, 40)]
# SM counts of cards the launcher may meet (the H100 SXM has 132)
SCAN_SMS = [1, 8, 16, 66, 114, 132, 144]
# splits by hand: (N, F, T) and ScanSplit(rows, chunks, blocks, cols)
HAND_SPLITS = [
    ((37, 5, 3), ref.ScanSplit(5, 8, 1, 32)),      # last chunk of 2 rows
    ((37, 5, 3), ref.ScanSplit(1, 64, 1, 4)),      # 27 chunks past N
    ((37, 5, 3), ref.ScanSplit(37, 1, 1, 256)),    # one chunk, in order
    ((333, 64, 16), ref.ScanSplit(11, 32, 1, 8)),  # last chunk 3, one past
    ((333, 64, 16), ref.ScanSplit(1, 512, 16, 8)),  # a row a chunk, 179 past
    ((517, 13, 21), ref.ScanSplit(7, 80, 5, 16)),  # two passes, T > 16
    ((4099, 64, 40), ref.ScanSplit(33, 128, 8, 16)),
    ((4099, 64, 16), ref.ScanSplit(2, 2112, 66, 8)),  # 66 blocks: 4 a lane
]


def split_cases():
    cases = {(shape, ops.scan_split(*shape, sms))
             for shape in SCAN_SHAPES for sms in SCAN_SMS}
    return sorted(cases) + HAND_SPLITS


@pytest.mark.parametrize("shape,split", split_cases())
def test_scan_in_kernel_order_matches_plain(shape, split):
    """The card's order, emulated, at every split the launcher picks for
    the scan shapes on every SM count above, and at splits by hand with a
    short last chunk and chunks past N: bit-equal to the plain version
    (both sum in f64 and round once, and these sums are exact)."""
    N, F, T = shape
    args = t(*scan_case(N + F + T, N, F, T))
    assert torch.equal(ref.scan_in_kernel_order(*args, split),
                       ref.stump_scan_ref(*args))


def test_scan_in_kernel_order_is_its_own_order():
    """Where an f64 sum is not exact the emulation follows its split.
    Weights 1, 2**-24 and four of 2**-54: in one chunk each 2**-54 is lost
    (under half of f64's last place at 1) and 1 + 2**-24 rounds to 1 in
    f32 (a tie, to even); in two blocks of one chunk of three rows each
    the second block adds three of them exactly first, and the total, 3/4
    of a last place over the tie, rounds up to 1 + 2**-23."""
    N = 6
    x = torch.zeros((N, 1))
    y = -torch.ones(N)                              # x > -1: every row misses
    thr = torch.full((1, 1), -1.0)
    w = torch.tensor([1.0, 2.0 ** -24] + [2.0 ** -54] * 4)
    one = ref.scan_in_kernel_order(x, y, w, thr,
                                   ref.ScanSplit(N, 1, 1, 256))
    two = ref.scan_in_kernel_order(x, y, w, thr, ref.ScanSplit(3, 2, 2, 256))
    assert one.item() == 1.0
    assert two.item() == 1.0 + 2.0 ** -23


@pytest.mark.parametrize("sms", SCAN_SMS)
@pytest.mark.parametrize("shape", SCAN_SHAPES + [(24000, 64, 16),
                                                 (0, 64, 16), (4, 48, 16)])
def test_scan_split_is_a_grid_the_kernel_takes(shape, sms):
    """What the launcher (csrc/stump_scan.cu) accepts: a power-of-two block
    width, 256 threads a block in whole chunks, every row in a chunk, at
    most 65,535 column groups; one block a column group where chunks of at
    most SCAN_ONE_PASS_ROWS rows do or the column groups alone give two
    blocks an SM, then the fewest rows a chunk among such candidates; else
    a grid of two blocks an SM."""
    N, F, T = shape
    s = ops.scan_split(N, F, T, sms)
    groups = -(-T // ops.SCAN_CHUNK) * -(-F // s.cols)
    assert s.cols in ops.SCAN_COLS and s.chunks % s.blocks == 0
    assert (s.chunks // s.blocks) * s.cols == ops.SCAN_THREADS
    assert s.rows * s.chunks >= N and s.rows >= 1 and groups <= 65535
    others = [ops.scan_candidate(N, F, T, sms, c) for c in ops.SCAN_COLS]
    if s.blocks == 1:
        assert s.rows <= ops.SCAN_ONE_PASS_ROWS or groups >= 2 * sms
        assert ops.scan_workspace(F, T, s) == 0
        assert s.rows == min(o.rows for o in others if o.blocks == 1)
    else:
        assert all(o.blocks > 1 for o in others) and s.cols == 8
        assert groups * s.blocks >= min(2 * sms, groups * -(-N // 32))
        assert ops.scan_workspace(F, T, s) == \
            s.blocks * groups * s.cols * ops.SCAN_CHUNK


def test_scan_split_covers_the_card_at_large_n():
    """(24000, 64, 16) on the H100 (132 SMs): two blocks an SM, where one
    block a feature left 68 of them idle; the path's shard (333 rows)
    takes one block a column group and one launch."""
    s = ops.scan_split(24000, 64, 16, 132)
    assert (64 // s.cols) * s.blocks >= 2 * 132
    s = ops.scan_split(333, 64, 16, 132)
    assert s.blocks == 1 and s.rows <= ops.SCAN_ONE_PASS_ROWS


def test_scan_split_walks_each_chunk_of_16_thresholds():
    """T > 16: a column group holds one chunk of 16 thresholds, so there
    are ceil(T / 16) times the column groups, and the emulation of the
    launcher's split still matches the plain version."""
    a = ops.scan_split(4099, 64, 16, 132)
    b = ops.scan_split(4099, 64, 40, 132)
    assert (64 // a.cols) * a.blocks >= 2 * 132
    assert 3 * (64 // b.cols) * b.blocks >= 2 * 132
    assert b.blocks < a.blocks
    args = t(*scan_case(9, 300, 7, 40))
    assert torch.equal(
        ref.scan_in_kernel_order(*args, ops.scan_split(300, 7, 40, 132)),
        ref.stump_scan_ref(*args))


@pytest.mark.parametrize("T,offset,want", [
    (16, 0, True), (40, 0, True), (4, 0, True),     # T % 4 == 0, aligned
    (21, 0, False), (1, 0, False), (6, 0, False),   # T % 4 != 0
    (16, 1, False), (16, 2, False), (16, 4, True)])  # views 4, 8, 16 B off
def test_scan_route_takes_16_byte_loads_only_where_aligned(T, offset, want):
    buf = torch.zeros(3 * 5 * T + offset)
    thr = buf[offset:].view(3, 5, T)
    assert thr.is_contiguous()
    err = torch.empty((3, 5, T))
    assert ops.scan_vec(T, thr, err) is want


@pytest.mark.parametrize("name,c_value", [
    ("SCAN_THREADS", "kThreads"), ("SCAN_CHUNK", "kChunk"),
    ("SCAN_MAX_BLOCKS", "32 * kMaxPerLane"),
    ("SCAN_BATCHED_THREADS", "kBatchThreads"),
    ("SCAN_MAX_CLUSTER", "kMaxCluster"),
    ("SCAN_SPLIT_MAX_GRID_Y", "kMaxGridY")])
def test_scan_constants_match_the_cuda_source(name, c_value):
    """The split chooser's constants are csrc/stump_scan.cu's: a split
    made from other ones would be refused by the launcher."""
    src = (Path(ops.__file__).parent / "csrc" / "stump_scan.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert getattr(ops, name) == eval(c_value, {}, consts)
    assert ref.SCAN_CLUSTER_LEAVES == consts["kMaxCluster"]


# the batched scan's route: (B, N, F, T) -> the split taken on 132 SMs
BATCHED_ROUTES = [((10, 43575, 54, 16), True),     # fed_mesh's ten shards
                  ((1, 24000, 64, 16), True),
                  ((100000, 4, 48, 16), False),    # a fleet wave
                  ((4096, 333, 64, 16), False),    # large shards
                  ((8, 37, 48, 16), False),        # few rows a slot
                  ((8000, 300, 1, 200), False)]    # past gridDim.y
BATCHED_SHAPES = [shape for shape, _ in BATCHED_ROUTES] + [
    (10, 43575, 54, 40), (3, 1000, 13, 21), (100, 300, 54, 16),
    (131, 500, 64, 16), (2, 256, 1, 1), (5041, 300, 1, 208),
    (5042, 300, 1, 208)]


@pytest.mark.parametrize("shape,split", BATCHED_ROUTES)
def test_scan_batched_split_picks_the_route_from_the_shape(shape, split):
    """One thread a row wherever its blocks reach every SM (a fleet wave,
    large shards), a slot's rows are few, or the split's grid would pass
    65,535 (slot, chunk of 16 thresholds) pairs; the split where B·F
    leaves SMs idle and N is long."""
    assert (ops.scan_batched_split(*shape, 132) is not None) is split


@pytest.mark.parametrize("sms", SCAN_SMS)
@pytest.mark.parametrize("shape", BATCHED_SHAPES)
def test_scan_batched_split_is_a_grid_the_kernel_takes(shape, sms):
    """What the launcher's split route accepts: blocks of 8 features, 256
    threads a block in whole chunks, one cluster of 1 to 8 blocks a column
    group, every row in a chunk, at most 65,535 (slot, chunk of 16
    thresholds) pairs; and the cost model's least among the cluster sizes
    it may take."""
    B, N, F, T = shape
    picked = ops.scan_batched_split(B, N, F, T, sms)
    pairs = B * -(-T // ops.SCAN_CHUNK)
    if picked is None:
        assert -(-B * F // ops.SCAN_BATCHED_THREADS) >= sms \
            or N < ops.SCAN_SPLIT_MIN_ROWS or pairs > 65535
        return
    s = picked
    assert s.cols == ops.SCAN_SPLIT_COLS == 8
    assert 1 <= s.blocks <= ops.SCAN_MAX_CLUSTER
    assert s.chunks % s.blocks == 0
    assert (s.chunks // s.blocks) * s.cols == ops.SCAN_THREADS
    assert s.rows >= 1 and s.rows * s.chunks >= N
    assert (s.rows - 1) * s.chunks < N                 # no row to spare
    assert -(-F // s.cols) * s.blocks < 2 ** 31 and pairs <= 65535
    kb = ops.SCAN_THREADS // 8
    groups = B * -(-F // 8) * -(-T // ops.SCAN_CHUNK)

    def cost(G):
        return -(-groups * G // (2 * sms)) * (
            -(-N // (kb * G)) + ops.SCAN_SPLIT_TREE_ROWS)
    sizes = [G for G in range(1, 9) if groups * G <= 2 * sms
             or G in (1, 2, 4, 8)]
    assert s.blocks in sizes
    assert cost(s.blocks) == min(cost(G) for G in sizes)
    assert s.blocks == min(G for G in sizes if cost(G) == cost(s.blocks))


def batched_split_cases():
    cases = {(shape, ops.scan_batched_split(*shape, sms))
             for shape in [(3, 1000, 13, 21), (10, 2000, 54, 16),
                           (2, 517, 5, 3)] for sms in SCAN_SMS}
    return sorted((c for c in cases if c[1] is not None),
                  key=lambda c: (c[0], tuple(c[1]))) + [
        ((3, 1000, 13, 21), ref.ScanSplit(1000, 1, 1, 256)),  # in order
        ((3, 1000, 13, 21), ref.ScanSplit(5, 256, 8, 8)),     # 56 past N
        ((3, 1000, 13, 21), ref.ScanSplit(2, 512, 2, 1)),
        ((2, 517, 5, 3), ref.ScanSplit(9, 64, 4, 16)),
        ((2, 517, 5, 3), ref.ScanSplit(1, 768, 3, 1))]


@pytest.mark.parametrize("shape,split", batched_split_cases())
def test_scan_batched_in_kernel_order_matches_plain(shape, split):
    """The split route's order, emulated: bit-equal to the plain version
    on the fleet's test batches (zero-weight rows and a zero-weight slot;
    these sums are exact in any order), and so to the row route's."""
    args = t(*batched_scan_case(sum(shape), *shape))
    want = ref.stump_scan_batched_ref(*args)
    assert torch.equal(ref.scan_batched_in_kernel_order(*args, split), want)
    assert torch.equal(ref.scan_batched_in_kernel_order(*args, None), want)


def wide_weights(rng, shape):
    """f32 weights of full mantissas spanning 2**40: f64 sums of them are
    not exact, so their order shows."""
    w = (1.0 + rng.rand(*shape)) * 2.0 ** -rng.randint(0, 41, size=shape)
    return w.astype(np.float32)


@pytest.mark.parametrize("blocks", range(1, 9))
def test_scan_batched_in_kernel_order_is_the_single_scan_per_slot(blocks):
    """With one slot the batched order is the single scan's wherever the
    combine is the same, which it is at every cluster size: a pairwise
    tree padded with zeros to 8 leaves is the second pass's tree padded
    to 32."""
    x, y, _, thr = batched_scan_case(blocks, 1, 700, 9, 21)
    w = wide_weights(np.random.RandomState(blocks), (1, 700))
    x, y, w, thr = t(x, y, w, thr)
    split = ref.ScanSplit(-(-700 // (32 * blocks)), 32 * blocks, blocks, 8)
    assert torch.equal(ref.scan_batched_in_kernel_order(x, y, w, thr, split),
                       ref.scan_in_kernel_order(x[0], y[0], w[0], thr[0],
                                                split)[None])


def ordered_oracle(x, y, w, thr, split):
    """err[b,f,t] in numpy f64, summed in the split route's order one
    addition at a time: each chunk's rows in order from zero, a block's
    chunks as a grid of I rows of R, a pairwise tree over i and then over
    q, the cluster's block sums a pairwise tree over 8 leaves (zeros past
    the blocks); rounded once to f32."""
    rows, chunks, blocks, _ = split
    B, N, F = x.shape
    kb = chunks // blocks
    R = kb // 16 if kb >= 16 else 1

    def tree(vals):
        while len(vals) > 1:
            vals = [vals[i] + vals[i + 1] for i in range(0, len(vals), 2)]
        return vals[0]

    out = np.empty(thr.shape, np.float32)
    for b in range(B):
        above = x[b][:, :, None] > thr[b][None]
        miss = np.where(above, (y[b] != 1.0)[:, None, None],
                        (y[b] != -1.0)[:, None, None])
        terms = np.where(miss, w[b].astype(np.float64)[:, None, None], 0.0)
        sums = []
        for c in range(chunks):
            acc = np.zeros(thr.shape[1:])
            for n in range(c * rows, min(N, (c + 1) * rows)):
                acc = acc + terms[n]
            sums.append(acc)
        block_sums = []
        for r in range(blocks):
            mine = sums[r * kb:(r + 1) * kb]
            block_sums.append(tree([tree([mine[i * R + q]
                                          for i in range(kb // R)])
                                    for q in range(R)]))
        zeros = [np.zeros(thr.shape[1:])] * (8 - blocks)
        out[b] = tree(block_sums + zeros).astype(np.float32)
    return out


@pytest.mark.parametrize("shape,split", [
    ((2, 600, 9, 21), ref.ScanSplit(3, 256, 8, 8)),
    ((2, 600, 9, 21), ref.ScanSplit(7, 96, 3, 8)),
    ((2, 600, 9, 21), ref.ScanSplit(3, 256, 1, 1)),
    ((1, 600, 70, 16), ref.ScanSplit(10, 64, 4, 16)),
    ((3, 300, 5, 3), ref.ScanSplit(1, 320, 5, 4))])
def test_scan_batched_in_kernel_order_is_its_order_at_wide_weights(shape,
                                                                   split):
    """Weights spanning 2**40, labels 0, 0.5 and NaN among the +-1: the
    emulation equals the oracle summed in the split route's order."""
    B, N, F, T = shape
    x, y, _, thr = batched_scan_case(N + F, B, N, F, T)
    y[:, ::7], y[:, 3::11], y[:, 5::13] = 0.0, 0.5, np.nan
    w = wide_weights(np.random.RandomState(N), (B, N))
    got = ref.scan_batched_in_kernel_order(*t(x, y, w, thr), split)
    assert np.array_equal(got.numpy(), ordered_oracle(x, y, w, thr, split))


def order_case():
    """One slot, one stump that misses every row, weights 1, 2**-24,
    2**-53, 2**-53: in order each 2**-53 is half of f64's last place at
    1 + 2**-24 and is lost (a tie, to even), and 1 + 2**-24 rounds to 1 in
    f32 (a tie, to even); a chunk a row in one block adds the two 2**-53
    first, and 1 + 2**-24 + 2**-52 rounds up to 1 + 2**-23."""
    x = torch.zeros((1, 4, 1))
    y = -torch.ones((1, 4))                         # x > -1: every row misses
    thr = torch.full((1, 1, 1), -1.0)
    w = torch.tensor([[1.0, 2.0 ** -24, 2.0 ** -53, 2.0 ** -53]])
    return x, y, w, thr


def test_scan_batched_in_kernel_order_is_its_own_order():
    args = order_case()
    split = ref.ScanSplit(1, 4, 1, 64)
    assert ref.scan_batched_in_kernel_order(*args, None).item() == 1.0
    assert ref.scan_batched_in_kernel_order(*args, split).item() == \
        1.0 + 2.0 ** -23


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,T", [(1, 1, 1), (333, 64, 16), (517, 13, 21),
                                   (4099, 64, 40), (24000, 64, 16),
                                   (1000, 64, 1), (700, 20, 21)])
def test_stump_scan_kernel_matches_plain_on_card(card, N, F, T):
    args = [a.to(card) for a in t(*scan_case(N, N, F, T))]
    before = ops.LAUNCHES["stump_scan"]
    got = ops.stump_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stump_scan"] == before + 1
    want = ref.stump_scan_ref(*args)
    torch.testing.assert_close(got, want, **TOL)
    # both sum in f64 and round once: equal bit for bit
    assert torch.equal(got, want)
    split = ops.scan_split(N, F, T, ops._sms(got.get_device()))
    assert torch.equal(got.cpu(), ref.scan_in_kernel_order(
        *[a.cpu() for a in args], split))
    # run to run the same bits
    assert torch.equal(ops.stump_scan(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split", split_cases() + [
    ((24000, 64, 16), ref.ScanSplit(47, 512, 16, 8)),
    ((24000, 64, 16), ref.ScanSplit(24, 1024, 64, 16)),
    ((24000, 64, 16), ref.ScanSplit(94, 256, 4, 4)),
    ((24000, 64, 16), ref.ScanSplit(2, 16384, 512, 8)),  # the most blocks
    ((1000, 64, 1), ref.ScanSplit(7, 160, 5, 8)),       # T 1
    ((700, 20, 21), ref.ScanSplit(9, 80, 5, 16))])
def test_stump_scan_kernel_is_the_fixed_order_on_card(card, shape, split):
    """Any split the kernel takes, across chunk, warp and block edges, in
    one launch or two: bit-equal to the emulation of its order and to the
    plain version."""
    N, F, T = shape
    host = t(*scan_case(N + F + T, N, F, T))
    args = [a.to(card) for a in host]
    got = ops._stump_scan_launch(*args, split)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.scan_in_kernel_order(*host, split))
    assert torch.equal(got, ref.stump_scan_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,split", [
    ((37, 5, 3), ref.ScanSplit(1, 8, 1, 32)),       # 8 rows of 37
    ((4099, 64, 16), ref.ScanSplit(1, 2112, 66, 8))])  # two passes
def test_stump_scan_launcher_refuses_a_split_short_of_n(card, shape, split):
    """Chunks that do not reach the last row would leave rows unsummed:
    the launcher refuses the split and launches nothing."""
    N, F, T = shape
    args = [a.to(card) for a in t(*scan_case(N, N, F, T))]
    before = ops.LAUNCHES["stump_scan"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops._stump_scan_launch(*args, split)
    assert ops.LAUNCHES["stump_scan"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,F,T", [
    (B, N, F, T) for B in (1, 3, 8) for N in (1, 3, 4, 37)
    for F in (1, 5, 48) for T in (1, 16)]
    # 70,000 slots: more than gridDim.y's 65,535; 333 rows: a large shard
    + [(70_000, 4, 2, 16), (4096, 333, 64, 16)])
def test_stump_scan_batched_kernel_matches_plain_on_card(card, B, N, F, T):
    args = [a.to(card) for a in t(*batched_scan_case(B + N, B, N, F, T))]
    before = ops.LAUNCHES["stump_scan_batched"]
    got = ops.stump_scan_batched(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stump_scan_batched"] == before + 1
    # both sum over the rows in order in f64 and round once
    assert torch.equal(got, ref.stump_scan_batched_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,T,B", [(333, 64, 16, 3), (24000, 64, 16, 2),
                                     (37, 5, 21, 5)])
def test_scan_kernels_take_any_label_on_card(card, N, F, T, B):
    """Labels other than +1 and -1 (0, 0.5, NaN) are missed by both
    predictions, as in the plain versions: both kernels give their bits,
    the single one at one launch and at two."""
    x, y, w, thr = scan_case(N + T, N, F, T)
    y[::7], y[3::11], y[5::13] = 0.0, 0.5, np.nan
    host = t(x, y, w, thr)
    args = [a.to(card) for a in host]
    got = ops.stump_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.stump_scan_ref(*args))
    split = ops.scan_split(N, F, T, ops._sms(got.get_device()))
    assert torch.equal(got.cpu(), ref.scan_in_kernel_order(*host, split))
    bx, by, bw, bt = (np.stack([a] * B) for a in (x, y, w, thr))
    bargs = [a.to(card) for a in t(bx, by, bw, bt)]
    assert torch.equal(ops.stump_scan_batched(*bargs),
                       ref.stump_scan_batched_ref(*bargs))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,F,T,offset,vec", [
    (5, 37, 48, 21, 0, False),      # T % 4 != 0: 4-byte loads and stores
    (5, 37, 48, 16, 1, False),      # thresholds 4 bytes off 16
    (5, 37, 48, 16, 4, True),       # 16 bytes off: aligned again
    (3, 4, 48, 40, 0, True),        # T > 16 on the 16-byte route
    (7, 9, 3, 6, 0, False)])
def test_stump_scan_batched_kernel_routes_on_card(card, B, N, F, T, offset,
                                                  vec):
    """The 16-byte and the 4-byte route, picked from T and the thresholds'
    alignment: both give the plain version's bits."""
    x, y, w, thr = t(*batched_scan_case(B + N + T, B, N, F, T))
    buf = torch.zeros(thr.numel() + offset, device=card)
    thr_card = buf[offset:].view(thr.shape)
    thr_card.copy_(thr)
    args = [a.to(card) for a in (x, y, w)]
    err = torch.empty((B, F, T), device=card)
    assert ops.scan_vec(T, thr_card, err) is vec
    got = ops.stump_scan_batched(*args, thr_card)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.stump_scan_batched_ref(x, y, w, thr))


# short ``spin_kernel`` markers that open a traced session
LEAD_MARKERS = 8


def lead_markers():
    """``LEAD_MARKERS`` short kernels to open a traced session: in a
    process that ran earlier sessions the profiler drops the records of a
    session's first kernels, by count and not by time (on the H100 one or
    two in a row; a marker a millisecond long went with the kernel after
    it), and the drop then falls on markers."""
    for _ in range(LEAD_MARKERS):
        torch.cuda._sleep(1000)


def traced_batched_scan(call):
    """``call()`` on the card, traced: its result, after asserting one
    device operation, a kernel named ``stump_scan_batched_kernel``.
    ``spin_kernel`` markers come before (:func:`lead_markers`) and after
    the call inside the trace, and are left out of the count."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lead_markers()
        got = call()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    traced = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [n for n in traced if "spin_kernel" not in n]
    assert len(names) == 1 and "stump_scan_batched_kernel" in names[0], \
        traced
    return got


def one_batched_scan_on_card(args, **knobs):
    """One ``stump_scan_batched`` call on the card, traced
    (:func:`traced_batched_scan`), one launch counted."""
    before = ops.LAUNCHES["stump_scan_batched"]
    got = traced_batched_scan(lambda: ops.stump_scan_batched(*args, **knobs))
    assert ops.LAUNCHES["stump_scan_batched"] == before + 1
    return got


def launch_batched_split(args, split, threads=0, depth=0):
    """``stump_scan_batched_launch`` called with a split built by hand
    (and the row route's ``threads`` and ``depth``): its errors, or a
    RuntimeError with the launcher's CUDA error."""
    from repro_torch.kernels.build import load
    x, y, w, thr = args
    B, N, F = x.shape
    T = thr.shape[2]
    err = torch.empty_like(thr)
    rc = load().stump_scan_batched_launch(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), thr.data_ptr(),
        err.data_ptr(), B, N, F, T, int(ops.scan_vec(T, thr, err)), threads,
        depth, *split, ops._stream(x))
    if rc != 0:
        raise RuntimeError(f"stump_scan_batched_launch: CUDA error {rc}")
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,data", [
    ((10, 43575, 54, 16), "plain"),     # fed_mesh's ten covtype shards
    ((10, 43575, 54, 16), "wide"),
    ((3, 1000, 13, 21), "plain"),       # T 21, F not a multiple of 8
    ((5, 777, 54, 16), "plain"),        # N not a multiple of a chunk
    ((3, 1000, 13, 21), "labels"),
    ((3, 1000, 13, 21), "wide"),
    ((1, 24000, 64, 16), "wide")])
def test_stump_scan_batched_split_is_the_emulated_order_on_card(card, shape,
                                                                 data):
    """Where B·F leaves SMs idle and N is long the split route runs, one
    launch a call, and gives the bits of its order's emulation: on the
    fleet's test batches (a zero-weight slot, zero-weight rows), with
    labels 0, 0.5 and NaN, and with weights spanning 2**40; where the sums
    are exact, the plain version's bits too (held on the CPU).  The
    trace's one kernel a call is held by
    :func:`test_stump_scan_batched_split_is_one_traced_kernel_on_card`,
    at smaller shapes."""
    B, N, F, T = shape
    x, y, w, thr = batched_scan_case(B + N + F + T, B, N, F, T)
    if data == "labels":
        y[:, ::7], y[:, 3::11], y[:, 5::13] = 0.0, 0.5, np.nan
    if data == "wide":
        w = wide_weights(np.random.RandomState(N), (B, N))
    host = t(x, y, w, thr)
    args = [a.to(card) for a in host]
    split = ops.scan_batched_split(B, N, F, T, ops._sms(args[0].get_device()))
    assert split is not None
    before = ops.LAUNCHES["stump_scan_batched"]
    got = ops.stump_scan_batched(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["stump_scan_batched"] == before + 1
    assert torch.equal(got.cpu(), ref.scan_batched_in_kernel_order(*host,
                                                                  split))
    if data != "wide":
        assert torch.equal(got.cpu(), ref.stump_scan_batched_ref(*host))
    assert torch.equal(ops.stump_scan_batched(*args), got)   # run to run


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1000, 13, 21), (5, 777, 54, 16)])
def test_stump_scan_batched_split_is_one_traced_kernel_on_card(card, shape):
    """Through the wrapper, where the picker takes the split: one launch
    counted and one traced kernel a call, with the emulation's bits."""
    B, N, F, T = shape
    host = t(*batched_scan_case(B + N + F + T, B, N, F, T))
    args = [a.to(card) for a in host]
    split = ops.scan_batched_split(B, N, F, T, ops._sms(args[0].get_device()))
    assert split is not None
    got = one_batched_scan_on_card(args)
    assert torch.equal(got.cpu(), ref.scan_batched_in_kernel_order(*host,
                                                                  split))


def hand_split(N, cols, blocks):
    """256 // cols chunks a block over ``blocks`` blocks, rows enough to
    cover N."""
    chunks = ops.SCAN_THREADS // cols * blocks
    return ref.ScanSplit(-(-N // chunks), chunks, blocks, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("cols,blocks", [
    (8, g) for g in range(1, 9)] + [
    (c, 2) for c in (1, 2, 4, 16, 32, 64)] + [(64, 3), (1, 8)])
def test_stump_scan_batched_launcher_splits_give_their_order_on_card(
        card, cols, blocks):
    """Every split the launcher takes, built by hand (blocks of 1 to 64
    features, 1 to 8 blocks a cluster), at weights spanning 2**40 and at a
    shape the picker leaves to the row route: one kernel, the emulation's
    bits."""
    B, N, F, T = 6, 200, 13, 21
    x, y, _, thr = batched_scan_case(7, B, N, F, T)
    w = wide_weights(np.random.RandomState(7), (B, N))
    host = t(x, y, w, thr)
    args = [a.to(card) for a in host]
    split = hand_split(N, cols, blocks)
    got = traced_batched_scan(lambda: launch_batched_split(args, split))
    assert torch.equal(got.cpu(), ref.scan_batched_in_kernel_order(*host,
                                                                  split))


@pytest.mark.cuda
def test_stump_scan_batched_split_follows_its_own_order_on_card(card):
    """Where the order shows in f32 (see :func:`order_case`), the split
    gives its emulation's bits and the row route the plain version's."""
    args = [a.to(card) for a in order_case()]
    split = hand_split(4, 64, 1)
    assert split == ref.ScanSplit(1, 4, 1, 64)
    got = traced_batched_scan(lambda: launch_batched_split(args, split))
    assert got.item() == 1.0 + 2.0 ** -23
    assert ops.stump_scan_batched(*args).item() == 1.0        # row route


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [{"threads": 128}, {"depth": 4}])
def test_stump_scan_batched_launcher_refuses_both_routes_on_card(card,
                                                                 knobs):
    """A row route's knob with a split: the launcher refuses the call."""
    args = [a.to(card) for a in t(*batched_scan_case(3, 3, 1000, 13, 21))]
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch_batched_split(args, hand_split(1000, 8, 2), **knobs)


@pytest.mark.cuda
def test_stump_scan_batched_launcher_refuses_a_grid_past_its_limit_on_card(
        card):
    """A split of more than 65,535 (slot, chunk of 16 thresholds) pairs is
    refused by the launcher; the picker sends that shape to the row route,
    which runs it."""
    B, N, F, T = 8000, 300, 1, 200
    args = [a.to(card) for a in t(*batched_scan_case(5, B, N, F, T))]
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch_batched_split(args, hand_split(N, 8, 2))
    assert ops.scan_batched_split(B, N, F, T,
                                  ops._sms(args[0].get_device())) is None
    got = ops.stump_scan_batched(*args).cpu()
    some = [0, 1, B // 2, B - 1]                     # slots are independent
    assert torch.equal(got[some], ref.stump_scan_batched_ref(
        *[a.cpu()[some] for a in args]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,pad", [(1, 1, 1, 0), (2, 300, 64, 20),
                                       (3, 37, 1000, 5)])
def test_vote_kernels_match_plain_on_card(card, B, T, N, pad):
    args = [a.to(card) for a in t(*vote_case(N, B, T, N, pad))]
    got = ops.stump_vote_batched(*args)
    gm, g0, g1 = ops.stump_vote_fp_batched(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.stump_vote_batched_ref(*args), **TOL)
    wm, w0, w1 = ref.stump_vote_fp_batched_ref(*args)
    torch.testing.assert_close(gm, wm, **TOL)
    assert torch.equal(g0, w0) and torch.equal(g1, w1)


def generic_vote_case(seed, B, T, N, pad_t):
    rng = np.random.RandomState(seed)
    m = rng.uniform(-1, 1, (B, T, N)).astype(np.float32)
    m[:, ::4] = np.sign(m[:, ::4])                  # stump-like rows too
    alphas = rng.rand(B, T).astype(np.float32)
    if pad_t:
        m[:, -pad_t:] = 0.0                         # the batch's T padding
        alphas[:, -pad_t:] = 0.0
    return m, alphas


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,pad", [(1, 1, 1, 0), (2, 300, 64, 20),
                                       (3, 37, 1000, 5), (70_000, 3, 1, 1)])
def test_ensemble_vote_kernels_match_plain_on_card(card, B, T, N, pad):
    m, a = [x.to(card) for x in t(*generic_vote_case(T + N, B, T, N, pad))]
    before = dict(ops.LAUNCHES)
    got = ops.ensemble_vote_batched(m, a)
    got1 = ops.ensemble_vote(m[0], a[0])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ensemble_vote_batched"] == \
        before["ensemble_vote_batched"] + 1
    assert ops.LAUNCHES["ensemble_vote"] == before["ensemble_vote"] + 1
    torch.testing.assert_close(got, ref.ensemble_vote_batched_ref(m, a),
                               **TOL)
    torch.testing.assert_close(got1, ref.ensemble_vote_ref(m[0], a[0]),
                               **TOL)
    # t walks in order in one thread: B = 1 is the same sum bit for bit,
    # and the zero padding rows add exactly nothing
    assert torch.equal(got1, got[0])
    if pad:
        assert torch.equal(
            ops.ensemble_vote_batched(m[:, :T - pad].contiguous(),
                                      a[:, :T - pad].contiguous()), got)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_kernel_order_is_as_accurate_as_the_sequential_sum():
    """Signed alphas at T = 1024 (four stages): the kernel's order and a
    sequential f32 sum both stay within 1e-5 (1 + sum |alpha|) of an f64
    sum, and the kernel's order is no further from it than 2x the
    sequential sum's largest error."""
    rng = np.random.RandomState(16)
    B, T, N = 3, 1024, 200
    m = rng.uniform(-1, 1, (B, T, N)).astype(np.float32)
    m[:, ::4] = np.sign(m[:, ::4])
    a = rng.randn(B, T).astype(np.float32)
    exact = np.einsum("bt,btn->bn", a.astype(np.float64), m.astype(np.float64))
    slack = 1e-5 * (1.0 + np.abs(a).astype(np.float64).sum(1))[:, None]
    got = ref.vote_in_kernel_order(*t(m, a)).numpy().astype(np.float64)
    seq = np.zeros((B, N), np.float32)
    for tt in range(T):
        seq = seq + a[:, tt, None] * m[:, tt]
    err, err_seq = np.abs(got - exact), np.abs(seq - exact)
    assert (err <= slack).all() and (err_seq <= slack).all()
    assert err.max() <= 2.0 * err_seq.max(), (err.max(), err_seq.max())
    # and the emulation is the plain version's function
    torch.testing.assert_close(ref.vote_in_kernel_order(*t(m, a)),
                               ref.ensemble_vote_batched_ref(*t(m, a)),
                               rtol=0, atol=float(slack.max()))


@pytest.mark.parametrize("T", [1, 31, 32, 33, 255, 256, 257, 300, 513])
def test_kernel_order_is_batch_invariant(T):
    """The order the card is held to, on the CPU, at T on both sides of a
    chunk (32 rows) and a stage (256 rows): the plain version's function
    within rtol/atol 1e-5, and zero padding rows in T and zero columns in
    N change no column's bits."""
    m, a = generic_vote_case(T, 2, T, 5, 0)
    got = ref.vote_in_kernel_order(*t(m, a))
    torch.testing.assert_close(got, ref.ensemble_vote_batched_ref(*t(m, a)),
                               **TOL)
    pad = np.zeros((3, T + 40, 9), np.float32)      # 40 rows, 4 columns
    pad[1:, :T, 2:7] = m
    pad_a = np.zeros((3, T + 40), np.float32)
    pad_a[1:, :T] = a
    packed = ref.vote_in_kernel_order(*t(pad, pad_a))
    assert torch.equal(bits(packed[1:, 2:7]), bits(got))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N", [
    # N % 4 in {0, 1, 3}: the 16-byte route and the scalar one
    (2, 300, 64), (2, 300, 65), (2, 300, 67),
    # T across a stage boundary
    (3, 255, 130), (3, 256, 130), (3, 257, 130),
    (1, 1024, 8192), (70_000, 3, 1), (70_000, 3, 4),
    # grids of more tiles than SMs: half a chunk in flight a round
    (300, 600, 130), (200, 257, 67)])
def test_ensemble_vote_kernel_is_the_fixed_order_on_card(card, B, T, N):
    m, a = t(*generic_vote_case(B + T + N, B, T, N, 2))
    want = ref.vote_in_kernel_order(m, a)
    m, a = m.to(card), a.to(card)
    got = ops.ensemble_vote_batched(m, a)
    # 1e-5 of 1 + sum |alpha|: a long sum that cancels keeps the rounding
    # of its partial sums, in either order
    slack = 1e-5 * (1.0 + a.abs().sum(1, keepdim=True))
    assert ((got - ref.ensemble_vote_batched_ref(m, a)).abs() <= slack).all()
    assert torch.equal(bits(got.cpu()), bits(want))
    # run to run the same bits
    assert torch.equal(bits(ops.ensemble_vote_batched(m, a)), bits(got))
    if B == 1:
        assert torch.equal(bits(ops.ensemble_vote(m[0], a[0])), bits(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [300, 1024])
def test_ensemble_vote_kernel_is_batch_invariant_on_card(card, T):
    """Three columns alone (B 1, N 3: the scalar route, a whole chunk of
    loads a round) and packed among others into (SMs + 8, T + 24, 8) with
    zero padding rows (the 16-byte route, more tiles than SMs: half a
    chunk a round) give the same bits."""
    B = torch.cuda.get_device_properties(card).multi_processor_count + 8
    rng = np.random.RandomState(T)
    m, a = generic_vote_case(T, B, T + 24, 8, 24)
    at = [(0, 0), (B // 2, 3), (B - 1, 7)]          # (b, n) of each column
    alone_m = np.stack([m[b, :T, n] for b, n in at], 1)[None]
    alone_a = rng.rand(1, T).astype(np.float32)
    for j, (b, n) in enumerate(at):
        m[b, :T, n] = alone_m[0, :, j]
        a[b, :T] = alone_a[0]
    m, a, alone_m, alone_a = [x.to(card) for x in t(m, a, alone_m, alone_a)]
    alone = ops.ensemble_vote_batched(alone_m, alone_a)[0]
    packed = ops.ensemble_vote_batched(m, a)
    assert torch.equal(bits(torch.stack([packed[b, n] for b, n in at])),
                       bits(alone))
    assert torch.equal(bits(ops.ensemble_vote(alone_m[0], alone_a[0])),
                       bits(alone))
    assert torch.equal(bits(alone.cpu()),
                       bits(ref.vote_in_kernel_order(*t(
                           alone_m.cpu().numpy(), alone_a.cpu().numpy()))[0]))


# ------------------------------------------------------------ stump votes
def stump_case(seed, B, T, N, pad_t):
    """A stump batch whose last ``pad_t`` rows are zero-alpha padding:
    thr and pol NaN on every other padding row, random on the rest."""
    xsel, thr, pol, alphas = vote_case(seed, B, T, N, pad_t)
    if pad_t:
        thr[:, T - pad_t::2] = np.nan
        pol[:, T - pad_t::2] = np.nan
    return xsel, thr, pol, alphas


@pytest.mark.parametrize("B,T,N,pad", [(1, 1, 1, 0), (2, 7, 5, 2),
                                       (3, 300, 64, 20), (2, 33, 129, 0),
                                       (2, 255, 17, 0), (2, 256, 17, 3),
                                       (2, 257, 17, 1)])
def test_stump_vote_order_matches_plain_and_jax(jax_ref, B, T, N, pad):
    """The stump kernels' order (the generic votes' order over the stump
    margins), emulated on the CPU: within rtol/atol 1e-5 of the plain
    version and of the JAX package's, at the vote shapes and at T on both
    sides of a stage (256 rows)."""
    jnp, jref = jax_ref
    args = vote_case(B * T + N, B, T, N, pad)
    got = ref.stump_vote_in_kernel_order(*t(*args))
    assert got.shape == (B, N) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.stump_vote_batched_ref(*t(*args)),
                               **TOL)
    want = np.asarray(jref.stump_vote_batched_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T", [1, 31, 32, 33, 255, 256, 257, 300, 513])
def test_stump_vote_order_is_batch_invariant(T):
    """Three columns alone and packed among others, behind 40 zero-alpha
    padding rows whose thr and pol hold NaN and random values, in a
    batch of other tenants: the same bits."""
    xsel, thr, pol, alphas = stump_case(T, 1, T, 3, 0)
    alone = ref.stump_vote_in_kernel_order(*t(xsel, thr, pol, alphas))
    px, pt, pp, pa = stump_case(T + 1, 3, T + 40, 9, 40)
    px[1, :T, 2:5] = xsel[0]
    pt[1, :T], pp[1, :T], pa[1, :T] = thr[0], pol[0], alphas[0]
    assert np.isnan(pt[1, T:]).any() and np.isnan(pp[1, T:]).any()
    packed = ref.stump_vote_in_kernel_order(*t(px, pt, pp, pa))
    assert torch.isfinite(packed).all()
    assert torch.equal(bits(packed[1, 2:5]), bits(alone[0]))


def test_one_product_a_row_is_the_two_products_bit_for_bit():
    """fl(a * fl(p * s)) == s * fl(a * p) in f32 for s in {-1, 0, 1}, over
    random values, +-0, subnormal and near-overflow alphas: what lets the
    kernel form alpha * pol once a row and select +-ap or 0 a cell.  A
    chunk sum starts at +0 and so is never -0: adding the select's +0
    where the product is -0 gives the same bits."""
    rng = np.random.RandomState(18)
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    a = np.concatenate([
        rng.rand(4000).astype(f32), -rng.rand(1000).astype(f32),
        np.array([0.0, -0.0, tiny, -tiny, tiny / 2, tiny / 1024,
                  np.nextafter(f32(0), f32(1))], f32),
        (rng.rand(500) * tiny).astype(f32),                 # subnormal
        (rng.rand(500) * 0.5 + 0.5).astype(f32) * np.finfo(f32).max])
    # polarities: +-1, +-0, and values of magnitude below 1 (no overflow)
    p = np.concatenate([np.array([1.0, -1.0, 0.0, -0.0], f32),
                        (rng.rand(64) * 2 - 1).astype(f32),
                        (rng.rand(16) * tiny).astype(f32)])
    A, P = np.meshgrid(a, p, indexing="ij")
    ap = A * P
    assert ap.dtype == np.float32 and np.isfinite(ap).all()
    c = np.concatenate([rng.randn(A.size // 2).astype(f32),
                        np.zeros(A.size - A.size // 2, f32)]).reshape(A.shape)
    for s in (f32(-1), f32(0), f32(1)):
        two = A * (P * s)
        one = s * ap
        np.testing.assert_array_equal(two.view(np.int32), one.view(np.int32))
        sel = ap if s > 0 else (-ap if s < 0 else np.zeros_like(ap))
        np.testing.assert_array_equal((c + two).view(np.int32),
                                      (c + sel).view(np.int32))


@pytest.mark.parametrize("source", ["ensemble_vote.cu", "stump_vote.cu"])
def test_vote_order_constants_match_the_cuda_sources(source):
    """The emulation's chunk and stage are each vote source's kRows and
    kWarps: an emulation of another order would not hold the card."""
    src = (Path(ops.__file__).parent / "csrc" / source).read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["kRows"], consts["kWarps"]) == (ref.VOTE_ROWS,
                                                   ref.VOTE_WARPS)
    assert ref.VOTE_STAGE_ROWS == ref.VOTE_ROWS * ref.VOTE_WARPS


# the launcher's routes on a 132-SM card: tiles of 32, 64 or 128 columns
# (the narrowest that keeps the grid within one block an SM), one or two
# stages a round, a whole chunk or half a chunk of loads in flight
STUMP_ORDER_SHAPES = [
    (1, 1, 1),
    # the serving shapes: 32-column tiles, two stages a round; N % 4 in
    # {0, 1, 3}
    (2, 300, 64), (2, 300, 61), (2, 300, 67),
    # T across a stage boundary
    (3, 255, 130), (3, 256, 130), (3, 257, 130), (3, 37, 1000),
    # two stages a round over 9 stages (the last round one stage)
    (1, 1024, 256), (1, 2100, 64),
    # 64-column tiles (two stages a round, one), 128-column tiles within
    # one block an SM (16-byte and 4-byte loads)
    (1, 1024, 8192), (1, 200, 8192), (1, 300, 16384), (1, 300, 16383),
    # grids of more tiles than SMs: half a chunk in flight a round
    (8, 1024, 4096), (70_000, 3, 4), (300, 600, 130), (200, 257, 67)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N", STUMP_ORDER_SHAPES)
def test_stump_vote_kernels_are_the_fixed_order_on_card(card, B, T, N):
    """Both stump kernels bit-equal to the CPU emulation of their order
    and to each other, the lanes bit-equal to the plain version's, with
    zero-alpha padding rows of NaN thr and pol; two calls the same bits."""
    pad = min(T - 1, 3)
    x, th, p, a = t(*stump_case(B + T + N, B, T, N, pad))
    want = ref.stump_vote_in_kernel_order(x, th, p, a)
    w0, w1 = ref._fp_lanes(x, a)
    args = [v.to(card) for v in (x, th, p, a)]
    got = ops.stump_vote_batched(*args)
    gm, g0, g1 = ops.stump_vote_fp_batched(*args)
    again = ops.stump_vote_batched(*args)
    am, a0, a1 = ops.stump_vote_fp_batched(*args)
    torch.cuda.synchronize()
    assert torch.equal(bits(got.cpu()), bits(want))
    assert torch.equal(bits(gm), bits(got))
    assert torch.equal(g0.cpu(), w0) and torch.equal(g1.cpu(), w1)
    assert torch.equal(bits(again), bits(got))
    assert torch.equal(bits(am), bits(got))
    assert torch.equal(a0, g0) and torch.equal(a1, g1)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [300, 1024])
def test_stump_vote_kernels_are_batch_invariant_on_card(card, T):
    """Three columns alone (B 1, N 3: a 32-column tile, two stages a
    round) and packed among others into (8, T + 24, 4096) behind 24
    zero-alpha padding rows of NaN and random thr and pol (128-column
    tiles, the 16-byte route, more tiles than SMs: one stage and half a
    chunk a round), through both kernels: the same bits, and the CPU
    emulation's."""
    xsel, thr, pol, alphas = stump_case(T, 1, T, 3, 0)
    px, pt, pp, pa = stump_case(T + 1, 8, T + 24, 4096, 24)
    at = [(0, 0), (4, 2049), (7, 4095)]             # (b, n) of each column
    for j, (b, n) in enumerate(at):
        px[b, :T, n] = xsel[0, :, j]
        pt[b, :T], pp[b, :T], pa[b, :T] = thr[0], pol[0], alphas[0]
    alone_args = [v.to(card) for v in t(xsel, thr, pol, alphas)]
    packed_args = [v.to(card) for v in t(px, pt, pp, pa)]
    alone = ops.stump_vote_batched(*alone_args)[0]
    alone_fp = ops.stump_vote_fp_batched(*alone_args)[0][0]
    packed = ops.stump_vote_batched(*packed_args)
    packed_fp = ops.stump_vote_fp_batched(*packed_args)[0]
    want = ref.stump_vote_in_kernel_order(*t(xsel, thr, pol, alphas))[0]
    for got in (alone_fp, torch.stack([packed[b, n] for b, n in at]),
                torch.stack([packed_fp[b, n] for b, n in at])):
        assert torch.equal(bits(got), bits(alone))
    assert torch.equal(bits(alone.cpu()), bits(want))


# ----------------------------------------------------------- dist_update
def dist_case(N, seed=None):
    """A normalised distribution, +-1 labels, margins in [-1, 1] with a
    third of them stump-like (exactly +-1)."""
    rng = np.random.RandomState(N if seed is None else seed)
    D = rng.rand(N).astype(np.float32)
    D /= D.sum()
    y = np.where(rng.rand(N) < 0.5, 1.0, -1.0).astype(np.float32)
    h = rng.uniform(-1, 1, N).astype(np.float32)
    h[::3] = np.sign(h[::3])
    return D, y, h


def dist_capacity(sms):
    """Samples the grid route keeps on chip on a card of ``sms`` SMs."""
    return sms * ops.DIST_HELD * 4


# the route boundaries at ``sms`` SMs: the last cluster size (4 * 8 * 1024
# samples) and the on-chip capacity, each +-1
CLUSTER_MAX = 4 * ops.DIST_CLUSTER * ops.DIST_THREADS
DIST_BOUNDARIES = [CLUSTER_MAX - 1, CLUSTER_MAX, CLUSTER_MAX + 1]


def dist_boundary_ns(sms):
    cap = dist_capacity(sms)
    return DIST_BOUNDARIES + [cap - 1, cap, cap + 1]


@pytest.mark.parametrize("N", [1, 37, 8192, 8193] + DIST_BOUNDARIES
                         + ["cap-1", "cap", "cap+1"])
def test_dist_update_kernel_order_matches_jax(jax_ref, N):
    """The CPU emulation of csrc/dist_update.cu's order against the JAX
    package's plain version, at the split the wrapper picks: 132 SMs, and
    2 SMs for the capacity boundary (where the grid starts to compute w
    again), which lies at 7.6 M samples on 132.  Z rel 1e-6 (an f64 sum
    in another order, rounded once), D' atol 1e-6."""
    jnp, jref = jax_ref
    sms = 132
    if isinstance(N, str):
        sms = 2
        N = dist_capacity(sms) + {"cap-1": -1, "cap": 0, "cap+1": 1}[N]
    split = ops.dist_split(N, sms)
    D, y, h = dist_case(N)
    for alpha in (0.7, -0.3, 0.0):
        got, z = ref.dist_update_in_kernel_order(alpha, *t(D, y, h), split)
        want, wz = jref.dist_update_ref(alpha, *map(jnp.asarray, (D, y, h)))
        assert z.shape == () and z.dtype == torch.float32
        np.testing.assert_allclose(float(z), float(wz), rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_dist_update_kernel_order_is_its_tree():
    """The emulation adds what the kernel adds where it adds it: thread
    sums in sample order, a warp's tree, the block sums lane by lane.
    Weights picked so that each order rounds its own way."""
    # thread 0 holds samples 0..3 (1 + 2^-24, exact in f64), thread 1
    # 4..7 (3 * 2^-54); the warp's tree adds the two: past the f32 tie,
    # so Z rounds up.  In sample order each 2^-54 is lost against 1 and Z
    # is the tie, rounded to even: 1.
    w = torch.tensor([1.0, 2.0 ** -24, 0.0, 0.0] + [2.0 ** -54] * 3 + [0.0],
                     dtype=torch.float64).float()
    assert float(w.sum()) == 1.0
    ones = torch.ones(8)
    _, z = ref.dist_update_in_kernel_order(
        0.0, w, ones, ones, ref.DistSplit(True, 1, 32, 2, 2))
    assert z.item() == 1.0 + 2.0 ** -23
    # every split of these samples covers each one exactly once
    D, y, h = t(*dist_case(1000, 3))
    want = ref.dist_update_ref(0.0, D, y, h)[1]
    for split in (ops.dist_split(1000, 132), ops.dist_split(1000, 3),
                  ref.DistSplit(False, 3, 64, 84, 0),
                  ref.DistSplit(False, 40, 32, 7, 7)):
        got = ref.dist_update_in_kernel_order(0.0, D, y, h, split)[1]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


DIST_SMS = [132, 114, 78, 16, 2]


@pytest.mark.parametrize("sms", DIST_SMS)
def test_dist_split_picks_each_route_at_its_boundaries(sms):
    """One cluster up to CLUSTER_MAX samples, a cooperative grid beyond;
    the grid keeps w on chip up to sms * DIST_HELD float4 and computes
    the rest again past that.  Every split is one the launcher takes and
    that stays resident: threads a power of two from 32 to 1024 (512 on
    the grid), the least that holds the tile; a cluster of the fewest
    blocks (a power of two up to 8) that gives each at most 256 vectors
    (1024 at 8 blocks); a grid of at most one block an SM with no empty
    block; at most DIST_HELD vectors kept a block (224 KB of shared
    memory)."""
    cap = dist_capacity(sms)
    ns = sorted({1, 2, 5, 37, 1020, 1021, 1024, 1025, 8192, 8193, 4_194_304,
                 10_000_000, *dist_boundary_ns(sms)})
    for N in ns:
        s = ops.dist_split(N, sms)
        nv = -(-N // 4)
        assert s.cluster == (N <= CLUSTER_MAX), (N, s)
        assert s.blocks * s.tile >= nv and (s.blocks - 1) * s.tile < nv
        assert 32 <= s.threads <= 1024 and s.threads & (s.threads - 1) == 0
        most = ops.DIST_THREADS if s.cluster else ops.DIST_GRID_THREADS
        need = min(s.tile, most)                # the least that holds it
        assert s.threads >= need and (s.threads == 32 or s.threads < 2 * need)
        assert s.held == min(s.tile, ops.DIST_HELD)
        if s.cluster:                            # the fewest blocks
            assert s.blocks in (1, 2, 4, 8) and s.tile <= 1024
            assert s.tile <= 256 or s.blocks == 8
            assert s.blocks == 1 or -(-nv // (s.blocks // 2)) > 256
        else:
            assert s.blocks <= sms and s.tile == -(-nv // sms)
        assert (s.held < s.tile) == (N > cap), (N, cap, s)
    assert ops.dist_split(8192, 132) == ref.DistSplit(True, 8, 256, 256, 256)
    assert ops.dist_split(4_194_304, 132) == ref.DistSplit(False, 132, 512,
                                                           7944, 7944)


@pytest.mark.parametrize("name,c_value", [
    ("DIST_CLUSTER", "kMaxCluster"), ("DIST_THREADS", "kMaxThreads"),
    ("DIST_HELD", "kMaxHeld")])
def test_dist_constants_match_the_cuda_source(name, c_value):
    """The split chooser's constants are csrc/dist_update.cu's: a split
    made from other ones would be refused by the launcher."""
    src = (Path(ops.__file__).parent / "csrc" / "dist_update.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert getattr(ops, name) == consts[c_value]


def test_dist_update_alpha_forms_give_equal_bits_on_cpu():
    """alpha as a Python float, a numpy float of either width or a 0-d
    CPU tensor: the same f32 alpha, so the same bits (the plain version
    and the emulation), and every one goes to the kernel by value."""
    D, y, h = t(*dist_case(4099, 5))
    alpha = float(np.float32(0.7))
    forms = [alpha, np.float32(alpha), np.float64(alpha),
             torch.tensor(alpha), torch.tensor(alpha, dtype=torch.float64)]
    split = ops.dist_split(4099, 132)
    want = ops.dist_update(alpha, D, y, h)
    want_k = ref.dist_update_in_kernel_order(alpha, D, y, h, split)
    for a in forms:
        for got, w in zip(ops.dist_update(a, D, y, h), want):
            assert torch.equal(got.view(torch.int32), w.view(torch.int32))
        for got, w in zip(ref.dist_update_in_kernel_order(a, D, y, h, split),
                          want_k):
            assert torch.equal(got.view(torch.int32), w.view(torch.int32))
        ptr, val = ops._alpha_arg(a, torch.device("cuda", 0))
        assert ptr is None and np.float32(val) == np.float32(alpha)
    with pytest.raises(ValueError):
        ops._alpha_arg(torch.ones(2), torch.device("cuda", 0))


@pytest.mark.parametrize("N", [1, 2, 8192, 8193, 100_000])
def test_dist_outputs_are_one_allocation(N):
    """D', Z and the grid route's f64 block sums: one buffer, D' at its
    start (16-byte aligned), Z right after it, the sums' address 8-byte
    aligned after Z with room for one a block; none where the route is a
    cluster."""
    split = ops.dist_split(N, 132)
    out, z, parts = ops._dist_outputs(N, split, torch.device("cpu"))
    assert out.shape == (N,) and z.shape == () and out.dtype == torch.float32
    assert z.untyped_storage().data_ptr() == out.data_ptr()
    assert z.data_ptr() == out.data_ptr() + 4 * N
    if split.cluster:
        assert parts is None
    else:
        storage = out.untyped_storage()
        assert parts % 8 == 0 and parts > z.data_ptr()
        end = storage.data_ptr() + storage.nbytes()
        assert parts + 8 * split.blocks <= end


def dist_on_card(card, N, seed=None):
    return [v.to(card) for v in t(*dist_case(N, seed))]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 37, 2048, 2049, 8192, 8193, 1_000_003,
                               4_194_304, 10_000_000] + DIST_BOUNDARIES
                         + ["cap-1", "cap", "cap+1"])
def test_dist_update_kernel_matches_plain_on_card(card, N):
    """One launch; D' within 1e-6 and Z within 1e-6 relative of the plain
    version; equal bits run to run and for alpha as a number and as a CUDA
    tensor; at alpha = 0 (w is D on both) Z bit-equal to the CPU emulation
    of the kernel's order, and D' too.  N at both route boundaries +-1 (the
    capacity's on this card) and above the capacity."""
    if isinstance(N, str):
        N = dist_capacity(ops._sms(0)) + {"cap-1": -1, "cap": 0,
                                          "cap+1": 1}[N]
    D, y, h = dist_on_card(card, N)
    before = ops.LAUNCHES["dist_update"]
    got, z = ops.dist_update(0.7, D, y, h)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dist_update"] == before + 1
    want, wz = ref.dist_update_ref(0.7, D, y, h)
    assert z.shape == () and z.dtype == torch.float32
    torch.testing.assert_close(z, wz, rtol=1e-6, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # one fixed order: equal run to run, alpha by value or by pointer
    again, z2 = ops.dist_update(torch.tensor(0.7, device=card), D, y, h)
    third, z3 = ops.dist_update(0.7, D, y, h)
    for a, b in ((again, got), (z2, z), (third, got), (z3, z)):
        assert torch.equal(bits(a), bits(b))
    split = ops.dist_split(N, ops._sms(0))
    got0, z0 = ops.dist_update(0.0, D, y, h)
    want0, wz0 = ref.dist_update_in_kernel_order(0.0, D.cpu(), y.cpu(),
                                                 h.cpu(), split)
    assert torch.equal(bits(z0.cpu()), bits(wz0))
    assert torch.equal(bits(got0.cpu()), bits(want0))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8192, 100_000, 4_194_304])
def test_dist_update_routes_not_taken_give_their_order_on_card(card, N):
    """The route the wrapper does not take at N, forced through the
    private launcher: the grid at the cluster's sizes, one cluster where
    it can hold N, and w computed again for every sample (held 0), each
    with Z bit-equal to the emulation of its split at alpha = 0; w
    computed again gives the bits of w kept."""
    D, y, h = dist_on_card(card, N)
    sms = ops._sms(0)
    nv = -(-N // 4)
    shipped = ops.dist_split(N, sms)
    forced = [shipped._replace(held=0)]
    if shipped.cluster:
        tile = -(-nv // sms)
        forced.append(ref.DistSplit(False, -(-nv // tile), max(32, 1 << (
            tile - 1).bit_length()), tile, tile))
    for split in forced:
        got0, z0 = ops._dist_update_launch(0.0, D, y, h, split)
        want0, wz0 = ref.dist_update_in_kernel_order(0.0, D.cpu(), y.cpu(),
                                                     h.cpu(), split)
        assert torch.equal(bits(z0.cpu()), bits(wz0)), split
        assert torch.equal(bits(got0.cpu()), bits(want0)), split
    kept = ops._dist_update_launch(0.7, D, y, h, shipped)
    again = ops._dist_update_launch(0.7, D, y, h, forced[0])
    for a, b in zip(kept, again):
        assert torch.equal(bits(a), bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8192, 4_194_304])
def test_dist_update_is_one_device_operation_on_card(card, N):
    """A call's whole device work, traced: one kernel, no fill and no
    copy of alpha to the card, with alpha a number or a CUDA tensor.
    ``spin_kernel`` markers before and after the calls take the records
    the profiler now and then drops (see :func:`traced_batched_scan`)."""
    from torch.profiler import ProfilerActivity, profile
    D, y, h = dist_on_card(card, N)
    a = torch.tensor(0.7, device=card)
    ops.dist_update(0.7, D, y, h)
    torch.cuda.synchronize()
    for alpha in (0.7, a):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_markers()
            for _ in range(5):
                ops.dist_update(alpha, D, y, h)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        traced = [e.name[:64] for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        names = [n for n in traced if "spin_kernel" not in n]
        assert len(names) == 5 and all("dist_update_kernel" in n
                                       for n in names), traced


@pytest.mark.cuda
def test_dist_update_with_a_number_alpha_never_syncs_on_card(card):
    """alpha as a number, a numpy float or a CPU tensor goes by value: on
    either route a call neither copies it to the card nor waits."""
    small = dist_on_card(card, 8192)
    large = dist_on_card(card, 100_000)
    for args in (small, large):                    # the build, outside
        ops.dist_update(0.7, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for alpha in (0.7, np.float32(0.7), torch.tensor(0.7)):
            for args in (small, large):
                ops.dist_update(alpha, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_dist_update_grid_that_cannot_be_resident_is_refused_on_card(card):
    """Four blocks an SM of 1024 threads and 224 KB each cannot all be
    resident: the cooperative launch returns its error (720) and runs
    nothing, and the next call works.  (The splits the wrapper picks, one
    block an SM, launch in the tests above.)"""
    sms = ops._sms(0)
    D, y, h = dist_on_card(card, 1000)
    bad = ref.DistSplit(False, 4 * sms, 1024, ops.DIST_HELD, ops.DIST_HELD)
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        ops._dist_update_launch(0.7, D, y, h, bad)
    got, z = ops.dist_update(0.7, D, y, h)
    torch.testing.assert_close(z, ref.dist_update_ref(0.7, D, y, h)[1],
                               rtol=1e-6, atol=0)


# ----------------------------------------------------------- flash_attention
# f32 at 2e-4 (the JAX package's own flash tolerance: sums over up to T keys
# in another order, and XLA's exp against PyTorch's), bf16 at 3e-2 (the
# inputs' and output's rounding)
FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
FLASH_BF16_TOL = dict(rtol=3e-2, atol=3e-2)
FLASH_SHAPES = [(1, 1, 128, 64), (2, 3, 256, 64), (1, 2, 512, 128),
                (2, 1, 384, 80)]


def flash_case(seed, B, H, T, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, T, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,T,d", FLASH_SHAPES)
def test_flash_attention_ref_matches_jax(jax_ref, B, H, T, d, causal):
    jnp, jref = jax_ref
    from repro.kernels import ops as jops
    args = flash_case(B * H * T + d, B, H, T, d)
    jargs = list(map(jnp.asarray, args))
    got = ref.flash_attention_ref(*t(*args), causal=causal).numpy()
    assert got.shape == (B, H, T, d) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(*jargs, causal=causal)),
        **FLASH_TOL)
    # the Pallas kernel itself, in interpret mode
    np.testing.assert_allclose(
        got, np.asarray(jops.flash_attention(*jargs, causal=causal,
                                             backend="interpret")),
        **FLASH_TOL)
    # a CPU tensor takes the plain version and launches nothing
    before = ops.LAUNCHES["flash_attention"]
    assert torch.equal(ops.flash_attention(*t(*args), causal=causal),
                       torch.from_numpy(got))
    assert ops.LAUNCHES["flash_attention"] == before


def test_flash_attention_ref_bf16_matches_jax(jax_ref):
    jnp, jref = jax_ref
    from repro.kernels import ops as jops
    args = flash_case(7, 1, 2, 256, 64)
    got = ref.flash_attention_ref(*[a.to(torch.bfloat16) for a in t(*args)])
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(*[jnp.asarray(a, jnp.bfloat16) for a in args],
                                backend="interpret")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **FLASH_BF16_TOL)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.flash_attention_ref(*map(jnp.asarray, args))),
        **FLASH_BF16_TOL)


def test_flash_attention_ref_causal_row_sees_only_its_past():
    # query i's output depends on no key or value past i
    q, k, v = t(*flash_case(3, 1, 2, 40, 16))
    base = ref.flash_attention_ref(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 25:] += 5.0
    v2[:, :, 25:] -= 3.0
    moved = ref.flash_attention_ref(q, k2, v2)
    assert torch.equal(moved[:, :, :25], base[:, :, :25])
    assert not torch.equal(moved[:, :, 25:], base[:, :, 25:])


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (a 10-bit mantissa), to nearest with ties away
    from zero, by bit masking: what ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(split: bool):
    """a @ b as the tensor cores compute it from TF32 operands, summed in
    f32: one product of the rounded operands, or with ``split`` the three
    products lo.hi + hi.lo + hi.hi of x = hi + lo (the kernel's f32
    route)."""
    def one(a, b):
        return tf32_rna(a) @ tf32_rna(b)

    def three(a, b):
        ah, bh = tf32_rna(a), tf32_rna(b)
        al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    return three if split else one


def attention_with(product, q, k, v):
    """Causal softmax attention in q's dtype with both products taken by
    ``product``, the softmax as the plain version takes it."""
    T, d = q.shape[-2:]
    s = product(q, k.transpose(-1, -2)) / np.sqrt(d)
    keep = torch.ones((T, T), dtype=torch.bool).tril()
    return product(torch.softmax(s.masked_fill(~keep, -1e30), -1), v)


def lm_path_qkv():
    """q, k, v as the LM path hands them to the kernel, from a reduced
    qwen1.5-0.5b prefill of 128 tokens (its first layer)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer
    cfg = reduced(get_arch("qwen1.5-0.5b"))
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(1))
    seen = []
    plain = ops.flash_attention

    def capture(q, k, v, **kw):
        seen.append([x.contiguous() for x in (q, k, v)])
        return plain(q, k, v, **kw)
    ops.flash_attention = capture
    try:
        with torch.no_grad():
            transformer.prefill(params, toks, cfg, 128)
    finally:
        ops.flash_attention = plain
    return seen[0]


@pytest.mark.parametrize("inputs", ["lm_path", "normal_q_x8"])
def test_split_tf32_holds_the_f32_tolerance_where_one_product_does_not(
        inputs):
    """The f32 route's accuracy claim, before the card runs it: against an
    f64 reference, attention from single TF32 products misses the f32
    tolerance (2e-4), the three-product split holds it with room to spare,
    on the LM path's own q, k, v and on unit normals with q scaled x8."""
    if inputs == "lm_path":
        q, k, v = lm_path_qkv()
    else:
        q, k, v = t(*flash_case(21, 2, 4, 128, 64))
        q = q * 8
    want = attention_with(lambda a, b: a @ b, q.double(), k.double(),
                          v.double())
    one = float((attention_with(tf32_product(False), q, k, v) - want)
                .abs().max())
    three = float((attention_with(tf32_product(True), q, k, v) - want)
                  .abs().max())
    assert one > FLASH_TOL["atol"] * 4
    assert three < FLASH_TOL["atol"] / 10


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    assert tf32_rna(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                    -(1.0 + 2.0 ** -9), 1.0, 3.0]


@pytest.mark.parametrize("Hkv", [4, 2, 1])
def test_flash_attention_cpu_path_takes_views_groups_and_out(Hkv):
    """On the CPU the wrapper reads the LM path's (B,T,H,d) views, k and v
    with Hkv heads (query head h reads head h // (H/Hkv)), and writes an
    ``out`` view of a (B,T,H,d) buffer: the plain version's result on
    contiguous copies with k and v repeated per group."""
    rng = np.random.RandomState(11 + Hkv)
    B, T, H, d = 2, 37, 4, 16
    q = torch.from_numpy(rng.randn(B, T, H, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, T, Hkv, d).astype(np.float32))
            for _ in range(2))
    buf = torch.full((B, T, H, d), float("nan"))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), out=buf.transpose(1, 2))
    assert got.data_ptr() == buf.data_ptr()
    G = H // Hkv
    want = ref.flash_attention_ref(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).repeat_interleave(G, 1).contiguous(),
        v.transpose(1, 2).repeat_interleave(G, 1).contiguous())
    torch.testing.assert_close(buf.transpose(1, 2), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape,dtype,view,padded_row", [
    ((2, 3, 5, 64), "float32", False, None),    # 256-byte rows: in place
    ((2, 5, 3, 64), "float32", True, None),     # the LM path's view
    ((2, 3, 5, 17), "float32", False, 20),      # 68-byte rows: padded
    ((2, 3, 5, 1), "float32", False, 4),
    ((2, 5, 3, 1), "float32", True, 4),         # 12-byte view rows
    ((2, 3, 5, 8), "bfloat16", False, None),    # 16-byte rows
    ((2, 3, 5, 12), "bfloat16", False, 16),
    ((1, 1, 1, 3), "float32", False, None),     # no row is ever stepped
])
def test_tma_ready_copies_only_what_a_tensor_map_cannot_read(
        shape, dtype, view, padded_row):
    x = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    x = x.to(getattr(torch, dtype))
    if view:
        x = x.transpose(1, 2)
    got = ops.tma_ready(x)
    assert torch.equal(got, x)
    if padded_row is None:
        assert got is x
    else:
        assert got.data_ptr() != x.data_ptr()
        assert got.stride() == (shape[1] * shape[2] * padded_row,
                                got.shape[2] * padded_row, padded_row, 1)
        assert got.data_ptr() % 16 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,T,d", FLASH_SHAPES + [
    (1, 1, 1, 64), (1, 2, 200, 64), (2, 2, 77, 32), (1, 2, 65, 17),
    (4, 16, 512, 64)])
def test_flash_attention_kernel_matches_plain_on_card(card, B, H, T, d,
                                                      causal):
    args = [a.to(card) for a in t(*flash_case(T + d, B, H, T, d))]
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(*args, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == (B, H, T, d) and got.dtype == torch.float32
    torch.testing.assert_close(
        got, ref.flash_attention_ref(*args, causal=causal), **FLASH_TOL)
    # a fixed k-tile order and no atomics: the same bits run to run
    assert torch.equal(ops.flash_attention(*args, causal=causal), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,d", [(1, 2, 256, 64), (2, 3, 200, 128),
                                     (1, 1, 130, 80)])
def test_flash_attention_kernel_bf16_on_card(card, B, H, T, d):
    args = [a.to(card, torch.bfloat16)
            for a in t(*flash_case(T, B, H, T, d))]
    got = ops.flash_attention(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(*args).float(),
                               **FLASH_BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [1, 8, 32, 64, 80, 96, 128])
@pytest.mark.parametrize("T", [1, 15, 64, 65, 200, 4096])
def test_flash_attention_kernel_grid_on_card(card, T, d, causal, dtype):
    """Every T and d of the grid, causal and full, f32 and bf16, with q
    scaled x8 (logits of some 8 standard deviations, where one TF32 product
    would miss 2e-4): contiguous (B,H,T,d) inputs, and the LM path's
    (B,T,H,d) buffers seen as (B,H,T,d) with the result written into a
    (B,T,H,d) buffer, give the plain version's result, and the same bits
    on a second call."""
    dt = getattr(torch, dtype)
    tol = FLASH_TOL if dt == torch.float32 else FLASH_BF16_TOL
    B, H = (1, 2) if T == 4096 else (2, 3)
    q, k, v = (a.to(card, dt) for a in t(*flash_case(131 * T + d, B, H,
                                                      T, d)))
    q = q * 8                       # a power of 2: exact in bf16 too
    want = ref.flash_attention_ref(q, k, v, causal=causal).float()
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (B, H, T, d) and got.dtype == dt
    torch.testing.assert_close(got.float(), want, **tol)
    assert torch.equal(ops.flash_attention(q, k, v, causal=causal), got)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    buf = torch.empty((B, T, H, d), dtype=dt, device=card)
    before = ops.LAUNCHES["flash_attention"]
    ops.flash_attention(*views, causal=causal, out=buf.transpose(1, 2))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(buf.transpose(1, 2).float(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv", [(8, 2), (6, 1)])
def test_flash_attention_kernel_groups_on_card(card, H, Hkv, dtype):
    """k and v with Hkv heads: query head h reads head h // (H/Hkv), as
    the plain version (which repeats them) computes."""
    dt = getattr(torch, dtype)
    tol = FLASH_TOL if dt == torch.float32 else FLASH_BF16_TOL
    rng = np.random.RandomState(H + Hkv)
    B, T, d = 2, 300, 64
    q = torch.from_numpy(rng.randn(B, H, T, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, Hkv, T, d).astype(np.float32))
            for _ in range(2))
    q, k, v = (x.to(card, dt) for x in (q, k, v))
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               ref.flash_attention_ref(q, k, v).float(),
                               **tol)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 1, 8, 64), device=card)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        ops.flash_attention(q, q[:, :, :4], q)
    wide = torch.zeros((1, 1, 8, 160), device=card)
    with pytest.raises(ValueError):
        ops.flash_attention(wide, wide, wide)
