"""The benchmark's frozen data generator against the program's."""
import numpy as np
import pytest

from perfbench.traffic import generator as gen

DOMAINS = [
    (dict(name="mobile_x4", n_samples=3000, n_features=48, n_clients=16,
          noniid_alpha=0.2, label_imbalance=0.5, noise=0.18), "dirichlet",
     {}),
    (dict(name="mobile_100k", n_samples=2048, n_features=48, n_clients=256,
          noniid_alpha=0.2, label_imbalance=0.5, noise=0.18), "iid",
     {"val_frac": 0.2, "test_frac": 0.004}),
    (dict(name="covtype", n_samples=2400, n_features=54, n_clients=10,
          noniid_alpha=0.5, label_imbalance=0.5, noise=0.2), "iid",
     {"val_frac": 0.25, "test_frac": 0.0}),
    (dict(name="adult", n_samples=1200, n_features=123, n_clients=10,
          noniid_alpha=0.5, label_imbalance=0.24, noise=0.15), "iid",
     {"val_frac": 0.3333402, "test_frac": 0.0}),
    (dict(name="mobile", n_samples=1200, n_features=12, n_clients=8,
          noniid_alpha=0.2, label_imbalance=0.5, noise=0.18), "label_shard",
     {}),
    (dict(name="iot", n_samples=800, n_features=24, n_clients=8,
          noniid_alpha=0.3, label_imbalance=0.15, noise=0.1), "dirichlet",
     {}),
    (dict(name="healthcare", n_samples=600, n_features=40, n_clients=6,
          noniid_alpha=0.5, label_imbalance=0.1, noise=0.05), "dirichlet",
     {}),
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dom,part,kw", DOMAINS,
                         ids=[d[0]["name"] for d in DOMAINS])
def test_copy_gives_the_programs_arrays_bit_for_bit(dom, part, kw, seed):
    from repro_torch.configs.paper_fedboost import DomainConfig
    from repro_torch.data import make_domain_data
    cfg = DomainConfig(straggler_factor=1.0, dropout_prob=0.0, link_mbps=1.0,
                       **dom)
    want = make_domain_data(cfg, seed=seed, partitioner=part, **kw)
    got = gen.make_domain_data(dom, seed=seed, partitioner=part, **kw)
    assert len(got["clients"]) == len(want["clients"])
    pairs = list(zip(got["clients"], want["clients"])) + [
        (got["val"], want["val"]), (got["test"], want["test"])]
    for (gx, gy), (wx, wy) in pairs:
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


def test_mesh_stacking_cuts_to_the_smallest_shard_and_k_slices():
    dom, part, kw = DOMAINS[0]
    data = gen.make_domain_data(dom, seed=0, partitioner=part, **kw)
    x, y, xv, yv = gen.stack_mesh(data, dom["n_clients"])
    n = min(c[0].shape[0] for c in data["clients"])
    nv = data["val"][0].shape[0] // dom["n_clients"]
    assert x.shape == (16, n, 48) and y.shape == (16, n)
    assert xv.shape == (16, nv, 48) and yv.shape == (16, nv)
    assert np.array_equal(x[3], data["clients"][3][0][:n])
    assert np.array_equal(xv.reshape(-1, 48), data["val"][0][:16 * nv])


def test_the_seed_lays_out_each_clients_rows_and_nothing_else():
    dom, part, kw = DOMAINS[0]
    stacked = gen.stack_mesh(gen.make_domain_data(dom, 0, partitioner=part,
                                                  **kw), 16)
    a, b = gen.permute_rows(stacked, 2**31 + 5), gen.permute_rows(stacked, 9)
    again = gen.permute_rows(stacked, 2**31 + 5)
    assert all(np.array_equal(u, v) for u, v in zip(a, again))
    assert not np.array_equal(a[0], b[0])
    for got in (a, b):
        for k in range(16):
            for i, j in ((0, 1), (2, 3)):
                rows = lambda arrs: sorted(
                    map(tuple, np.column_stack([arrs[i][k],
                                                arrs[j][k][:, None]])))
                assert rows(got) == rows(stacked)


def test_thresholds_are_each_features_interior_quantiles():
    x = np.random.default_rng(0).normal(size=(16, 8, 5)).astype(np.float32)
    thr = gen.thresholds(x, 16)
    flat = x.reshape(-1, 5).astype(np.float64)
    want = np.quantile(flat, np.arange(1, 17) / 17, axis=0).T
    assert thr.shape == (5, 16) and thr.dtype == np.float32
    assert np.array_equal(thr, want.astype(np.float32))


def test_a_configuration_states_its_rows_a_client():
    import json
    from perfbench import harness
    conf = json.loads((harness.ROOT / "perfbench/configs/covtype_10p.json")
                      .read_text())
    conf.update(n_samples=2400, rows_per_client=180, val_rows_per_client=60)
    x, y, xv, yv = gen.mesh_inputs(conf, 2**31 + 11)
    assert x.shape == (10, 180, 54) and xv.shape == (10, 60, 54)
    conf["rows_per_client"] = 181
    with pytest.raises(ValueError, match="rows a client"):
        gen.mesh_inputs(conf, 1)
