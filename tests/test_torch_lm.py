"""The port's LM serving stack against the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages (``jax.random`` inits cannot be drawn by ``torch.Generator``, so
the reference's init is carried across with
``convert.lm_params_from_numpy``, with its zero norms and biases moved off
zero so that they count).  Tolerances, each with its reason:

* layers (rms_norm, rope, softcap, MLPs): rtol/atol 1e-5, f32 rounding of
  two libraries;
* attention outputs: rtol/atol 2e-5, the same through two more products;
* KV caches: the reference's bf16 bits, except where the f32 value lies
  within ``STRADDLE`` (1e-6 of the tensor's largest magnitude, the size of
  the two libraries' f32 differences in a product) of the midpoint between
  two bf16 neighbours: there the last f32 bits decide the rounding and the
  caches may hold the two neighbours, one bf16 step apart;
* prefill logits: within ``LOGIT_REL`` (1e-5) of the largest |logit|;
* decode logits, on the port's own caches and, in lockstep, handed the
  reference's caches at every step: within ``DECODE_REL`` (2e-4) of the
  largest |logit|, since a cached key or value rounded to the other bf16
  neighbour moves its scores by up to 2^-8 of them (in lockstep only the
  step's own key and value can, so the error does not build up);
* greedy tokens: equal wherever the top-two gap of the port's logits
  exceeds ``DECODE_REL`` of the largest |logit|.

Each test imports JAX and the JAX package inside itself.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import Model, attention, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
STRADDLE = 1e-6
LOGIT_REL = 1e-5
DECODE_REL = 2e-4
ARCHS = ("qwen1.5-0.5b", "qwen2.5-3b", "gemma2-27b")


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _ref_cfg(name):
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_arch as jget_arch
    return jreduced(jget_arch(name))


def _cfgs(name, **over):
    """(the port's, the reference's) reduced config of one arch."""
    cfg = dataclasses.replace(reduced(get_arch(name)), **over)
    jcfg = dataclasses.replace(_ref_cfg(name), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _perturb(tree, seed):
    """The reference's params as numpy, norms and biases moved off 0."""
    jax, _ = _jax()
    rng = np.random.RandomState(seed)

    def one(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("norm", "'bq'", "'bk'", "'bv'")):
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(one, tree)


def _lm_params(jcfg, seed=0):
    """(numpy params, the same as jnp arrays) from the reference's init."""
    jax, jnp = _jax()
    from repro.models import transformer as jtr
    pn = _perturb(jtr.init_params(jax.random.key(seed), jcfg), seed)
    return pn, jax.tree.map(jnp.asarray, pn)


def _bits(a) -> np.ndarray:
    """bf16 values (a torch tensor or a JAX array) as uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _bf16_from_jax(a) -> torch.Tensor:
    return torch.from_numpy(_bits(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _bf16_floats(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16).float().numpy()


def _round_bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _assert_same_rounding(got_bf16, want_bf16, want_f32=None):
    """The port's bf16 cache against the reference's: the same bits except
    where the last f32 bits decide the rounding.  Given the reference's f32
    values, every port value must be the bf16 rounding of some f32 within
    ``STRADDLE`` of the tensor's largest magnitude of the reference's
    (rounding is monotone: between the roundings of ref -+ that distance);
    without them, within that distance plus one bf16 step of the
    reference's bf16 value."""
    gb, wb = _bits(got_bf16), _bits(want_bf16)
    assert gb.shape == wb.shape
    assert (gb != wb).mean() < 1e-2
    g, w = _bf16_floats(gb), _bf16_floats(wb)
    if want_f32 is not None:
        ref = np.asarray(want_f32, np.float32)
        d = STRADDLE * float(np.abs(ref).max())
        assert ((g >= _round_bf16(ref - d)) & (g <= _round_bf16(ref + d))).all()
    else:
        d = STRADDLE * float(np.abs(w).max())
        step = np.spacing(np.abs(w)) * 2.0 ** 16     # bf16 keeps 8 bits
        assert (np.abs(g - w) <= step + d).all()


def _logits_close(got, want, rel):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rel * scale, \
        (float(np.abs(got - want).max()), scale)


# ---------------------------------------------------------------- layers

def test_rms_norm_softcap_and_rope_match_jax():
    _, jnp = _jax()
    from repro.models import layers as jl
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 3, 32).astype(np.float32)
    w = (0.1 * rng.randn(32)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
        .numpy(), np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        **TOL)
    big = (30 * x).astype(np.float32)
    for cap in (0.0, 50.0):
        np.testing.assert_allclose(
            layers.softcap(torch.from_numpy(big), cap).numpy(),
            np.asarray(jl.softcap(jnp.asarray(big), cap)), **TOL)
    for theta in (10000.0, 1_000_000.0):
        np.testing.assert_allclose(
            layers.rope_frequencies(32, theta).numpy(),
            np.asarray(jl.rope_frequencies(32, theta)), **TOL)
        for pos in (np.arange(9, dtype=np.int32),
                    np.full((1,), 517, np.int32)):
            xp = x[:, :pos.shape[0]]
            np.testing.assert_allclose(
                layers.apply_rope(torch.from_numpy(xp), torch.from_numpy(pos),
                                  theta).numpy(),
                np.asarray(jl.apply_rope(jnp.asarray(xp), jnp.asarray(pos),
                                         theta)), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_embed_and_head_match_jax(act):
    _, jnp = _jax()
    from repro.models import layers as jl
    rng = np.random.RandomState(1)
    p = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    x = rng.randn(2, 5, 64).astype(np.float32)
    np.testing.assert_allclose(
        layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), act).numpy(),
        np.asarray(jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), act)), **TOL)
    table = (0.02 * rng.randn(128, 64)).astype(np.float32)
    ids = rng.randint(0, 128, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        layers.embed_apply(torch.from_numpy(table),
                           torch.from_numpy(ids)).numpy(),
        np.asarray(jl.embed_apply(jnp.asarray(table), jnp.asarray(ids))))
    for tied, w, cap in ((True, table, 0.0), (False, table.T.copy(), 30.0)):
        np.testing.assert_allclose(
            layers.lm_head_apply(torch.from_numpy(w), torch.from_numpy(x),
                                 tied, cap).numpy(),
            np.asarray(jl.lm_head_apply(jnp.asarray(w), jnp.asarray(x), tied,
                                        cap)), **TOL)


# ------------------------------------------------------------- attention

# (arch, overrides): MHA with QKV bias; GQA (8 q heads on 1 kv head);
# gemma2's sliding window with logit softcap (its local layer) and without
def _attn_cases():
    return [("qwen1.5-0.5b", {}), ("qwen2.5-3b", {}),
            ("gemma2-27b", {}), ("gemma2-27b", {"attn_softcap": 0.0})]


def _attn_params(cfg, jcfg, seed):
    _, jnp = _jax()
    rng = np.random.RandomState(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    pn = {k: (rng.randn(*s) / np.sqrt(s[0])).astype(np.float32)
          for k, s in shapes.items()}
    if cfg.qkv_bias:
        for k, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                     ("bv", cfg.n_kv_heads)):
            pn[k] = (0.1 * rng.randn(n * hd)).astype(np.float32)
    port = attention.Attention(cfg)
    with torch.no_grad():
        for name, t in port.named_parameters():
            t.copy_(torch.from_numpy(pn[name]))
    return port, {k: jnp.asarray(v) for k, v in pn.items()}


@pytest.mark.parametrize("arch,over", _attn_cases())
@pytest.mark.parametrize("kind", ["attn", "attn_local"])
def test_attn_apply_and_prefill_match_jax(arch, over, kind):
    _, jnp = _jax()
    from repro.models import attention as ja
    cfg, jcfg = _cfgs(arch, **over)
    port, jp = _attn_params(cfg, jcfg, 3)
    window = cfg.sliding_window if kind == "attn_local" else 0
    rng = np.random.RandomState(4)
    # T = 80 >= the window of 64: the local cache takes the ring branch,
    # the full cache (S = 96) the pad branch
    B, T, S = 2, 80, 96
    x = rng.randn(B, T, cfg.d_model).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    want = np.asarray(ja.attn_apply(jp, jnp.asarray(x), jcfg,
                                    positions=jnp.asarray(pos),
                                    window=window))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(
            attention.attn_apply(port, xt, cfg, window=window).numpy(),
            want, **ATTN_TOL)
        # explicit positions take the plain path: the same function
        np.testing.assert_allclose(
            attention.attn_apply(port, xt, cfg, window=window,
                                 positions=torch.from_numpy(pos),
                                 block_q=32).numpy(), want, **ATTN_TOL)
        got, cache = attention.attn_prefill(port, xt, cfg, kind=kind,
                                            cache_seq=S)
    wo, wc = ja.attn_prefill(jp, jnp.asarray(x), jcfg,
                             positions=jnp.asarray(pos), kind=kind,
                             cache_seq=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(wo), **ATTN_TOL)
    Sc = attention.cache_len(cfg, kind, S)
    assert cache["k"].shape == (B, Sc, cfg.n_kv_heads,
                                cfg.resolved_head_dim)
    assert cache["k"].dtype == torch.bfloat16
    # the reference's f32 keys and values, laid out as its cache
    _, kf, vf = ja._project_qkv(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    for key, f in (("k", kf), ("v", vf)):
        f = np.asarray(f)
        if T >= Sc:
            f = np.roll(f[:, T - Sc:], T % Sc, axis=1)
        else:
            f = np.pad(f, ((0, 0), (0, Sc - T), (0, 0), (0, 0)))
        _assert_same_rounding(cache[key], wc[key], f)


@pytest.mark.parametrize("arch,over", _attn_cases())
@pytest.mark.parametrize("kind", ["attn", "attn_local"])
def test_attn_decode_matches_jax_in_lockstep(arch, over, kind):
    _, jnp = _jax()
    from repro.models import attention as ja
    cfg, jcfg = _cfgs(arch, **over)
    port, jp = _attn_params(cfg, jcfg, 5)
    rng = np.random.RandomState(6)
    B, T, S = 2, 70, 72
    x = rng.randn(B, T, cfg.d_model).astype(np.float32)
    _, jc = ja.attn_prefill(jp, jnp.asarray(x), jcfg,
                            positions=jnp.arange(T, dtype=jnp.int32),
                            kind=kind, cache_seq=S)
    # past the cache's end on the local layer: the ring wraps
    for pos in range(T, T + 4):
        xd = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        cache = {k: _bf16_from_jax(v) for k, v in jc.items()}
        with torch.no_grad():
            got, cache = attention.attn_decode(port, torch.from_numpy(xd),
                                               cache, cfg, pos=pos,
                                               kind=kind)
        want, jc = ja.attn_decode(jp, jnp.asarray(xd), jc, jcfg,
                                  pos=jnp.asarray(pos, jnp.int32), kind=kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
        # the new key and value went into the ring slot pos % S, rounded
        _, kf, vf = ja._project_qkv(
            jp, jnp.asarray(xd), jcfg, jnp.full((1,), pos, jnp.int32))
        for key, f in (("k", kf), ("v", vf)):
            full = np.asarray(jc[key]).astype(np.float32)
            full[:, pos % cache[key].shape[1]] = np.asarray(f)[:, 0]
            _assert_same_rounding(cache[key], jc[key], full)


# ----------------------------------------------------------- transformer

def _cache_pairs(cfg, caches, jcaches):
    """(port's layer cache, reference's) for every layer: layer i is
    period i // p of slot i % p."""
    p = cfg.pattern_period
    for i, c in enumerate(caches):
        yield c, {k: v[i // p] for k, v in jcaches[i % p].items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_prefill_decode_and_forward_match_jax(arch):
    _, jnp = _jax()
    from repro.models import transformer as jtr
    cfg, jcfg = _cfgs(arch)
    pn, jp = _lm_params(jcfg)
    params = lm_params_from_numpy(pn, cfg)
    rng = np.random.RandomState(7)
    # T = 80 >= gemma2's window of 64: its local layers' caches take the
    # ring branch, and decode wraps them
    B, T, S, steps = 2, 80, 88, 4
    toks = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    with torch.no_grad():
        logits, caches = transformer.prefill(params, torch.from_numpy(toks),
                                             cfg, S)
        full, aux = transformer.forward(params, torch.from_numpy(toks[:, :24]),
                                        cfg)
    jlogits, jcaches = jtr.prefill(jp, jnp.asarray(toks), jcfg, S)
    _logits_close(logits, jlogits, LOGIT_REL)
    jfull, _ = jtr.forward(jp, jnp.asarray(toks[:, :24]), jcfg, remat=False)
    _logits_close(full, jfull, LOGIT_REL)
    assert float(aux) == 0.0
    assert len(caches) == cfg.n_layers
    for c, jc in _cache_pairs(cfg, caches, jcaches):
        for key in ("k", "v"):
            _assert_same_rounding(c[key], jc[key])

    own = caches
    for i in range(steps):
        tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        # lockstep: handed the reference's caches
        handed = [{k: _bf16_from_jax(v) for k, v in jc.items()}
                  for _, jc in _cache_pairs(cfg, own, jcaches)]
        with torch.no_grad():
            got, _ = transformer.decode_step(params, torch.from_numpy(tok),
                                             handed, T + i, cfg)
            mine, own = transformer.decode_step(params, torch.from_numpy(tok),
                                                own, T + i, cfg)
        want, jcaches = jtr.decode_step(jp, jnp.asarray(tok), jcaches,
                                        jnp.asarray(T + i, jnp.int32), jcfg)
        _logits_close(got, want, DECODE_REL)
        _logits_close(mine, want, DECODE_REL)
        # the step's key and value went into the handed caches in place
        for c, jc in _cache_pairs(cfg, handed, jcaches):
            for key in ("k", "v"):
                _assert_same_rounding(c[key], jc[key])


def test_greedy_generate_matches_jax():
    jax, jnp = _jax()
    from repro.launch.serve import generate as jgenerate
    from repro.models import Model as JModel
    cfg, jcfg = _cfgs("qwen1.5-0.5b")
    pn, jp = _lm_params(jcfg, seed=1)
    B, T0, n_new = 2, 16, 8
    prompts = np.random.RandomState(8).randint(
        0, cfg.vocab_size, (B, T0)).astype(np.int32)
    want = np.asarray(jgenerate(JModel(jcfg), jp, jnp.asarray(prompts), n_new,
                                cache_len=T0 + n_new))
    model = Model(cfg, device="cpu")
    steps = []
    got = generate(model, lm_params_from_numpy(pn, cfg),
                   torch.from_numpy(prompts), n_new, cache_len=T0 + n_new,
                   step_logits=steps).numpy()
    assert got.shape == want.shape == (B, T0 + n_new)
    assert len(steps) == n_new + 1
    np.testing.assert_array_equal(got[:, :T0], prompts)
    compared = 0
    for b in range(B):
        for i in range(n_new):
            top2 = torch.topk(steps[i][b], 2).values
            tol = DECODE_REL * float(steps[i][b].abs().max())
            if got[b, T0 + i] != want[b, T0 + i]:
                # a split is allowed only at a near-tie; after it the two
                # sequences differ in their inputs
                assert float(top2[0] - top2[1]) <= tol
                break
            compared += 1
    assert compared >= B * n_new // 2


# -------------------------------------------------- which path each layer runs

def _count_paths(monkeypatch):
    calls = {"flash": 0, "plain": 0}
    flash, plain = attention._flash, attention._sdpa_chunked

    def counted_flash(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)

    def counted_plain(*a, **k):
        calls["plain"] += 1
        return plain(*a, **k)
    monkeypatch.setattr(attention, "_flash", counted_flash)
    monkeypatch.setattr(attention, "_sdpa_chunked", counted_plain)
    return calls


@pytest.mark.parametrize("arch,over,flash,plain", [
    ("qwen1.5-0.5b", {}, 4, 0),
    ("qwen2.5-3b", {}, 4, 0),
    # gemma2 alternates local (window 64) and global layers, both with the
    # attention-logit softcap: every layer plain
    ("gemma2-27b", {}, 0, 4),
    # without the softcap its global layers run the kernel
    ("gemma2-27b", {"attn_softcap": 0.0}, 2, 2),
])
def test_prefill_runs_the_kernel_exactly_on_full_causal_layers(
        monkeypatch, arch, over, flash, plain):
    cfg = dataclasses.replace(reduced(get_arch(arch)), n_layers=4, **over)
    calls = _count_paths(monkeypatch)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    before = ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        transformer.prefill(params, toks, cfg, 16)
    assert calls == {"flash": flash, "plain": plain}
    # a CPU tensor takes the kernel's plain version: nothing launched
    assert ops.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("remat", [True, False])
def test_grad_mode_attention_never_calls_the_flash_kernel(monkeypatch, remat):
    """A training step's full causal layers take the chunked softmax (the
    kernel has no backward); the same layers under no_grad take the
    kernel."""
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b")), n_layers=4)
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    flash = ops.flash_attention

    def refused(*a, **k):
        raise AssertionError("ops.flash_attention called in grad mode")
    monkeypatch.setattr(ops, "flash_attention", refused)
    before = dict(attention.ROUTES)
    params.requires_grad_(True)
    loss, _ = transformer.loss_fn(params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    wq = [g for (n, _), g in zip(params.named_parameters(), grads)
          if n.endswith("attn.wq")]
    assert len(wq) == 4 and all(float(g.abs().max()) > 0 for g in wq)
    got = {k: attention.ROUTES[k] - before[k] for k in before}
    # remat runs each period's forward again in the backward pass
    assert got == {"flash": 0, "chunked": 0,
                   "chunked_grad": 8 if remat else 4}
    monkeypatch.setattr(ops, "flash_attention", flash)
    with torch.no_grad():
        transformer.prefill(params, toks, cfg, 16)
    assert attention.ROUTES["flash"] - before["flash"] == 4


@pytest.mark.parametrize("launcher", ["serve", "train"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "whisper-base"])
def test_launchers_run_every_family_on_cpu(capsys, arch, launcher):
    """``python -m repro_torch.launch.serve|train --arch ... --device cpu``
    on the MoE, SSM, hybrid and encoder-decoder families (reduced): the
    serve launcher generates, the training launcher logs finite losses (with
    the MoE aux term where the arch has MoE layers)."""
    from repro_torch.launch import serve, train
    if launcher == "serve":
        serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--tokens", "3"])
        assert "generated 2x3 tokens" in capsys.readouterr().out
        return
    train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    steps = [line.split() for line in out.splitlines()
             if line.startswith("step ")]
    assert len(steps) == 2
    for f in steps:
        loss, ce = float(f[3]), float(f[5])
        assert np.isfinite(loss) and np.isfinite(ce)
        moe_layers = reduced(get_arch(arch)).moe is not None
        assert (loss > ce) == moe_layers


def test_model_api_and_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    cfg = reduced(get_arch("qwen2.5-3b"))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_caches(2, 12)
    assert len(caches) == cfg.n_layers
    assert caches[0]["k"].shape == (2, 12, cfg.n_kv_heads, 32)
    toks = torch.randint(0, cfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": toks}, cache_seq=12)
        nxt, _ = model.decode_step(params, toks[:, :1], caches, 5)
    assert logits.shape == nxt.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(nxt).all()
    # temperature sampling draws from the given generator: same seed, same
    # tokens; every token is a true vocab id
    runs = [generate(model, params, toks, 6, 11, temperature=1.0,
                     gen=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].max()) < cfg.vocab_size
    serve.main(["--arch", "gemma2-27b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--tokens", "3"])
    assert "generated 2x3 tokens" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_card_launches_once_per_full_layer_and_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = reduced(get_arch(arch))
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu_params = cpu.init()
    cpu_params.load_state_dict(params.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 80), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    full = sum(kind == "attn" and cfg.attn_softcap == 0
               for kind, _ in transformer.layer_kinds(cfg))
    before = ops.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got, caches = model.prefill(params, {"tokens": toks}, cache_seq=88)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == before + full
        want, _ = cpu.prefill(cpu_params, {"tokens": toks.cpu()},
                              cache_seq=88)
    _logits_close(got.cpu(), want.numpy(), LOGIT_REL)


@pytest.mark.cuda
def test_training_step_gradients_on_card_match_cpu():
    """One training step's loss and gradients on the card against the
    CPU's, on the same weights: the flash kernel is not launched (it has
    no backward), and each gradient is within ``GRAD_REL`` of its leaf's
    largest magnitude (f32 products in two orders, through the backward
    pass)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    GRAD_REL = 1e-4
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b")), n_layers=4)
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu_params = cpu.init()
    cpu_params.load_state_dict(params.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 81),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for m, p in ((model, params), (cpu, cpu_params)):
        p.requires_grad_(True)
        b = {k: v.to(m.device) for k, v in batch.items()}
        before = ops.LAUNCHES["flash_attention"]
        loss, _ = m.loss(p, b)
        grads = torch.autograd.grad(loss, list(p.parameters()))
        assert ops.LAUNCHES["flash_attention"] == before
        out.append((float(loss), [g.cpu() for g in grads]))
    (loss, grads), (want_loss, want) = out
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for g, w in zip(grads, want):
        assert float((g - w).abs().max()) <= GRAD_REL * float(w.abs().max())
