"""The port's kernel layer against the JAX package's oracles.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held to
``repro.kernels.ref`` on the same numpy inputs, at ragged shapes with
thresholds placed exactly on data values: errors and margins within
rtol/atol 1e-5 (summation order only), fingerprint lanes bit for bit.
The CUDA kernels are held to the plain versions on the card
(``-m cuda``); those tests need neither JAX nor the JAX package, so they
run on a machine that has only PyTorch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

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
    vargs = t(*vote_case(2, 2, 9, 11, 3))
    assert torch.equal(ops.stump_scan(*sargs), ref.stump_scan_ref(*sargs))
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


@pytest.mark.cuda
@pytest.mark.parametrize("N,F,T", [(1, 1, 1), (333, 64, 16), (517, 13, 21),
                                   (4099, 64, 40)])
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
