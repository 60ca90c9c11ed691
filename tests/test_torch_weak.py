"""The port's stump learner against the JAX package's.

Threshold grids must be bit-equal on every paper domain's client shards
(both sides write the same f32 linear-interpolation formula).  Picks must
equal the reference's wherever its two least errors are more than 1e-5
apart.  Closer than that the reference's f32 sum may settle the pick by
its rounding; the port's pick must then be the least in exact arithmetic,
up to the f32 rounding of its f64 sums.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.data import make_domain_data as jax_domain_data  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import weak as jweak  # noqa: E402
from repro.sim.scenarios import DOMAINS as JAX_DOMAINS  # noqa: E402
from repro_torch.data import make_domain_data  # noqa: E402
from repro_torch.models import weak  # noqa: E402
from repro_torch.sim.scenarios import DOMAINS  # noqa: E402

DOMAIN_NAMES = ["edge_vision", "blockchain", "mobile", "iot", "healthcare"]


def test_domain_table_matches_reference():
    assert sorted(DOMAINS) == sorted(DOMAIN_NAMES)
    for name in DOMAIN_NAMES:
        assert (dataclasses.asdict(DOMAINS[name])
                == dataclasses.asdict(JAX_DOMAINS[name]))


@pytest.mark.parametrize("name", DOMAIN_NAMES)
def test_domain_data_matches_reference(name):
    mine = make_domain_data(DOMAINS[name], seed=0)
    ref = jax_domain_data(JAX_DOMAINS[name], seed=0, as_numpy=True)
    assert len(mine["clients"]) == len(ref["clients"])
    for (a, b), (c, d) in zip(mine["clients"] + [mine["val"], mine["test"]],
                              ref["clients"] + [ref["val"], ref["test"]]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("name", DOMAIN_NAMES)
def test_stump_thresholds_bit_equal_on_client_shards(name):
    data = make_domain_data(DOMAINS[name], seed=0)
    for x, _ in data["clients"]:
        want = np.asarray(jweak.stump_thresholds(jnp.asarray(x)))
        got = weak.stump_thresholds(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def _top_two_gap(err_pos):
    errs = np.sort(np.concatenate([err_pos.ravel(), 1.0 - err_pos.ravel()]))
    return float(errs[1] - errs[0])


@pytest.mark.parametrize("seed", range(10))
def test_fit_stump_picks_match_reference_where_gap_exceeds_tol(seed):
    rng = np.random.RandomState(seed)
    N, F = [(183, 5), (333, 24), (17, 1)][seed % 3]   # few shapes to compile
    x = rng.randn(N, F).astype(np.float32)
    y = np.where(x[:, 0] + 0.5 * rng.randn(N) > 0, 1.0, -1.0)
    y = y.astype(np.float32)
    w = rng.rand(N).astype(np.float32)
    w /= w.sum()
    thr_j = jweak.stump_thresholds(jnp.asarray(x))
    err = np.asarray(jref.stump_scan_ref(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(w), thr_j))
    want = jweak.fit_stump(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                           thr_j)
    xt = torch.from_numpy(x)
    got = weak.fit_stump(xt, torch.from_numpy(y), torch.from_numpy(w),
                         weak.stump_thresholds(xt))
    if _top_two_gap(err) <= 1e-5:
        # a near-tie the reference may settle by rounding: the port's pick
        # must be the least in exact arithmetic, to two f32 steps at 1.0
        # (the f64 sum's rounding to f32, and 1 - err's)
        thr = np.asarray(thr_j, np.float64)
        pred = np.where(x[:, :, None] > thr[None], 1.0, -1.0)
        miss = pred != y[:, None, None]
        exact = np.einsum("n,nft->ft", w.astype(np.float64), miss)
        f = int(got["feature"])
        col = int(np.nonzero(thr[f] == float(got["threshold"]))[0][0])
        mine = exact[f, col]
        if float(got["polarity"]) < 0:
            mine = 1.0 - mine
        least = min(exact.min(), 1.0 - exact.max())
        assert mine <= least + 2 * np.spacing(np.float32(1.0))
        return
    assert int(got["feature"]) == int(want["feature"])
    assert float(got["threshold"]) == float(want["threshold"])
    assert float(got["polarity"]) == float(want["polarity"])
    np.testing.assert_array_equal(
        weak.predict_stump(got, xt).numpy(),
        np.asarray(jweak.predict_stump(want, jnp.asarray(x))))


def test_exact_ties_take_the_first_candidate():
    # uniform weights, two features with the same split: every order of
    # summation must pick feature 0 with polarity +1
    x = np.array([[0., 0.], [1., 1.], [2., 2.], [3., 3.]], np.float32)
    y = np.array([-1., -1., 1., 1.], np.float32)
    w = np.full(4, 0.25, np.float32)
    thr = np.array([[1.5, 2.5], [1.5, 2.5]], np.float32)
    p = weak.fit_stump(*(torch.from_numpy(a) for a in (x, y, w, thr)))
    assert (int(p["feature"]), float(p["threshold"]),
            float(p["polarity"])) == (0, 1.5, 1.0)


def test_unported_learners_raise():
    """Every family the reference names builds now, and no name the
    reference lacks: the logistic and MLP params cross the wire in the
    reference's bytes, (F+1)*4 and (F*16+16+16+1)*4."""
    import jax
    assert weak.get_weak_learner("stump").name == "stump"
    with pytest.raises(KeyError):
        weak.get_weak_learner("forest")
    rng = np.random.RandomState(0)
    x = rng.randn(40, 7).astype(np.float32)
    y = np.where(x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    w = np.full(40, 1 / 40, np.float32)
    want_bytes = {"logistic": (7 + 1) * 4, "mlp": (7 * 16 + 16 + 16 + 1) * 4}
    for name in ("logistic", "mlp"):
        spec, jspec = weak.get_weak_learner(name), jweak.get_weak_learner(name)
        assert spec.name == jspec.name == name
        p = spec.fit(*(torch.from_numpy(a) for a in (x, y, w)),
                     torch.Generator().manual_seed(0))
        jp = jspec.fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                       jax.random.key(0))
        assert ({k: tuple(v.shape) for k, v in p.items()}
                == {k: tuple(v.shape) for k, v in jp.items()})
        assert spec.param_bytes(p) == jspec.param_bytes(jp) == want_bytes[name]
        assert spec.predict(p, torch.from_numpy(x)).shape == (40,)
