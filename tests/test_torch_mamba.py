"""The port's Mamba2 SSD block (``models/mamba.py``) and the stacks that
use it (mamba2-1.3b, the Jamba hybrid) against the JAX package's, on the
CPU.

Inputs come from a numpy seed; the reference's params are carried across
as numpy, with the zero-initialized leaves (norms, ``dt_bias``,
``conv_b``) moved off zero so that they count.  Tolerances, each with its
reason:

* ``_causal_conv``, ``_project``, ``_ssd``, ``mamba_forward`` and each
  ``mamba_decode`` step: rtol/atol ``TOL`` (1e-5), f32 products and sums in
  two libraries' orders (the decode state is f32 and carried, and is
  compared step by step);
* the block's gradients against ``jax.grad``: within ``GRAD_REL`` (1e-4)
  of each leaf's largest, as ``tests/test_torch_train.py`` holds them;
* the block in bf16: within ``BF16_REL`` (2^-6, four bf16 steps) of the
  largest |value|, the two libraries rounding their bf16 intermediates
  apart;
* stacks: prefill and forward logits within ``LOGIT_REL`` (1e-5) of the
  largest |logit|, as in ``tests/test_torch_lm.py``; decode logits, the
  Mamba layers' states and the gradients within ``STACK_REL`` (2e-4) of
  the largest magnitude (of each leaf, for a gradient): Jamba's attention
  layer keeps a bf16 KV cache, whose values may round to the other
  neighbour, and its 8-layer period carries f32 rounding through every
  layer of the backward pass;
* the JAX package's own property tests, ported: their tolerances
  (5e-3 chunked against stepwise, 2e-3 across chunk lengths, 1e-4 for
  causality);
* checkpoints read back across the packages: bit for bit.

Each test imports JAX and the JAX package inside itself.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.base import ArchConfig, MambaConfig, reduced  # noqa
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_tree  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import Model, mamba, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_REL = 1e-5
STACK_REL = 2e-4
GRAD_REL = 1e-4
BF16_REL = 2.0 ** -6
SSM_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")
MOVED = ("norm", "dt_bias", "conv_b", "'bq'", "'bk'", "'bv'")


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _cfg(chunk=8, d=64, head_dim=16, d_state=16):
    return ArchConfig(name="m", family="ssm", source="", n_layers=1,
                      d_model=d, n_heads=0, n_kv_heads=0, d_ff=0,
                      vocab_size=128,
                      mamba=MambaConfig(d_state=d_state, d_conv=4, expand=2,
                                        head_dim=head_dim, chunk=chunk))


def _jcfg(cfg):
    from repro.configs.base import ArchConfig as JA, MambaConfig as JM
    d = dataclasses.asdict(cfg)
    d["mamba"] = JM(**d["mamba"])
    return JA(**d)


def _moved(jax, tree, rng):
    def one(path, a):
        a = np.asarray(a)
        if any(k in jax.tree_util.keystr(path) for k in MOVED):
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(one, tree)


def _params(cfg, seed):
    """(numpy params, jnp params, the port's ParameterDict): the
    reference's init with its zero leaves moved off zero."""
    jax, jnp = _jax()
    from repro.models import mamba as jm
    pn = _moved(jax, jm.mamba_init(jax.random.key(seed), _jcfg(cfg)),
                np.random.RandomState(seed))
    port = mamba.mamba_init(None, cfg)
    with torch.no_grad():
        for k, t in port.items():
            t.copy_(torch.from_numpy(np.array(pn[k])))
    return pn, {k: jnp.asarray(v) for k, v in pn.items()}, port


def _x(shape, seed, scale=0.5):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# ------------------------------------------------------------- the block

def test_causal_conv_project_and_split_match_jax():
    _, jnp = _jax()
    from repro.models import mamba as jm
    cfg = _cfg()
    pn, jp, port = _params(cfg, 0)
    x = _x((2, 11, cfg.d_model), 1)
    z, xbc, dt = mamba._project(port, _t(x), cfg)
    jz, jxbc, jdt = jm._project(jp, jnp.asarray(x), _jcfg(cfg))
    for g, w in ((z, jz), (xbc, jxbc), (dt, jdt)):
        _close(g, w)
    assert dt.dtype == torch.float32
    conv = mamba._causal_conv(xbc, port["conv_w"], port["conv_b"])
    jconv = jm._causal_conv(jxbc, jp["conv_w"], jp["conv_b"])
    _close(conv, jconv)
    for g, w in zip(mamba._split_conv(conv, cfg),
                    jm._split_conv(jconv, _jcfg(cfg))):
        _close(g, w)
    # softplus is logaddexp(x, 0), also far out on both sides (atol: the
    # reference's compiled code flushes subnormal results to 0)
    v = np.array([-100.0, -20.0, -1.0, 0.0, 1.0, 19.0, 21.0, 100.0],
                 np.float32)
    import jax
    np.testing.assert_allclose(mamba._softplus(_t(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=np.finfo(np.float32).tiny)


# chunk lengths: one chunk per token, several, one over the whole
# sequence, and 16 for T = 24, which halves to 8 (24 % 16 != 0)
@pytest.mark.parametrize("chunk,T", [(1, 8), (4, 24), (8, 24), (32, 24),
                                     (16, 24), (32, 7)])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_matches_jax(chunk, T, carried):
    _, jnp = _jax()
    from repro.models import mamba as jm
    cfg = _cfg(chunk=chunk)
    mc = cfg.mamba
    di, nh, N = mc.d_inner(cfg.d_model), mc.n_heads(cfg.d_model), mc.d_state
    rng = np.random.RandomState(chunk + T)
    xin = rng.randn(2, T, di).astype(np.float32)
    Bp = rng.randn(2, T, N).astype(np.float32)
    Cp = rng.randn(2, T, N).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(2, T, nh))).astype(np.float32)
    A = -np.arange(1, nh + 1, dtype=np.float32)
    D = (1 + 0.1 * rng.randn(nh)).astype(np.float32)
    h0 = (rng.randn(2, nh, mc.head_dim, N).astype(np.float32)
          if carried else None)
    y, h = mamba._ssd(_t(xin), _t(Bp), _t(Cp), _t(dt), _t(A), _t(D), cfg,
                      None if h0 is None else _t(h0))
    jy, jh = jm._ssd(jnp.asarray(xin), jnp.asarray(Bp), jnp.asarray(Cp),
                     jnp.asarray(dt), jnp.asarray(A), jnp.asarray(D),
                     _jcfg(cfg), None if h0 is None else jnp.asarray(h0))
    _close(y, jy)
    _close(h, jh)
    assert h.dtype == torch.float32


@pytest.mark.parametrize("T", [2, 3, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_matches_jax(T, dtype):
    """The full-sequence block, its final state and its conv state (the
    last k-1 pre-conv rows, left-padded when T < k-1), in f32 and in bf16
    (``y`` cast back to the input's dtype), and a continuation from a
    carried state."""
    _, jnp = _jax()
    from repro.models import mamba as jm
    cfg = _cfg()
    pn, jp, port = _params(cfg, 2)
    x = _x((2, T, cfg.d_model), 3)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    if dtype == "bfloat16":
        port = type(port)({k: torch.nn.Parameter(
            v.to(tdt) if k not in ("dt_bias", "A_log", "D") else v,
            requires_grad=False) for k, v in port.items()})
        jp = {k: v.astype(jdt) if k not in ("dt_bias", "A_log", "D") else v
              for k, v in jp.items()}

        def close(g, w):
            g, w = g.detach().float().numpy(), np.asarray(w, np.float32)
            assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max()
    else:
        def close(g, w):
            _close(g, w)
    xt = _t(x).to(tdt)
    with torch.no_grad():
        out, st = mamba.mamba_forward(port, xt, cfg)
    jout, jst = jm.mamba_forward(jp, jnp.asarray(x).astype(jdt), _jcfg(cfg))
    assert out.dtype == tdt and st["conv"].dtype == tdt
    close(out, jout)
    close(st["ssm"], jst["ssm"])
    close(st["conv"], jst["conv"])
    assert st["conv"].shape == (2, 3, mamba.conv_dim(cfg))
    # continue from the carried state
    x2 = _x((2, 5, cfg.d_model), 4)
    with torch.no_grad():
        out2, st2 = mamba.mamba_forward(port, _t(x2).to(tdt), cfg,
                                        h0=st["ssm"], conv0=st["conv"])
    jout2, jst2 = jm.mamba_forward(jp, jnp.asarray(x2).astype(jdt),
                                   _jcfg(cfg), h0=jst["ssm"],
                                   conv0=jst["conv"])
    close(out2, jout2)
    close(st2["ssm"], jst2["ssm"])


@pytest.mark.parametrize("start", ["init", "prefill"])
def test_mamba_decode_step_by_step_matches_jax(start):
    """Decode from a zero state (its conv state bf16, as the stack's
    ``init_caches`` makes it) or from a prefill's state, 6 steps, each
    step's output and state against the reference's."""
    _, jnp = _jax()
    from repro.models import mamba as jm
    cfg = _cfg()
    pn, jp, port = _params(cfg, 5)
    if start == "init":
        st = mamba.init_mamba_state(cfg, 2, torch.bfloat16)
        jst = jm.init_mamba_state(_jcfg(cfg), 2, jnp.bfloat16)
        assert st["conv"].dtype == torch.bfloat16
    else:
        x = _x((2, 9, cfg.d_model), 6)
        with torch.no_grad():
            _, st = mamba.mamba_forward(port, _t(x), cfg)
        _, jst = jm.mamba_forward(jp, jnp.asarray(x), _jcfg(cfg))
    for i in range(6):
        xd = _x((2, 1, cfg.d_model), 10 + i)
        with torch.no_grad():
            out, st = mamba.mamba_decode(port, _t(xd), st, cfg)
        jout, jst = jm.mamba_decode(jp, jnp.asarray(xd), jst, _jcfg(cfg))
        _close(out, jout)
        _close(st["ssm"], jst["ssm"])
        _close(st["conv"], jst["conv"])
        # the window promotes the carried bf16 rows to f32, as there
        assert str(st["conv"].dtype).split(".")[1] == str(
            jst["conv"].dtype)


def test_mamba_forward_gradients_match_jax():
    jax, jnp = _jax()
    from repro.models import mamba as jm
    cfg = _cfg(chunk=8)
    pn, jp, port = _params(cfg, 7)
    x = _x((2, 24, cfg.d_model), 8)
    w = _x((2, 24, cfg.d_model), 9, 1.0)

    def jloss(p, x):
        out, st = jm.mamba_forward(p, x, _jcfg(cfg))
        return jnp.sum(out * w) + jnp.sum(st["ssm"])
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    port.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    out, st = mamba.mamba_forward(port, xt, cfg)
    loss = torch.sum(out * _t(w)) + torch.sum(st["ssm"])
    names = list(port.keys())
    grads = torch.autograd.grad(loss, [port[k] for k in names] + [xt])
    for name, g in zip(names + ["x"], grads):
        want = np.asarray(jgx if name == "x" else jg[name])
        assert np.isfinite(g.numpy()).all()
        rel = float(np.abs(g.numpy() - want).max()) / float(
            np.abs(want).max())
        assert rel <= GRAD_REL, (name, rel)


# ------------------------------------ the JAX package's own properties

def _own(cfg, seed=0):
    return mamba.mamba_init(torch.Generator().manual_seed(seed), cfg)


def test_mamba_chunked_equals_stepwise():
    """The SSD chunked scan and the O(1) decode recurrence are the same
    model: T steps of decode match the full forward, and the final
    states agree."""
    cfg = _cfg()
    p = _own(cfg)
    T = 24
    x = 0.5 * torch.randn(2, T, cfg.d_model,
                          generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, states = mamba.mamba_forward(p, x, cfg)
        st = mamba.init_mamba_state(cfg, 2)
        outs = []
        for t in range(T):
            o, st = mamba.mamba_decode(p, x[:, t:t + 1], st, cfg)
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(st["ssm"].numpy(), states["ssm"].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_mamba_chunk_size_invariance():
    cfg = _cfg()
    p = _own(cfg)
    x = 0.5 * torch.randn(1, 32, cfg.d_model,
                          generator=torch.Generator().manual_seed(1))
    outs = []
    with torch.no_grad():
        for chunk in (4, 8, 16, 32):
            c2 = dataclasses.replace(cfg, mamba=dataclasses.replace(
                cfg.mamba, chunk=chunk))
            outs.append(mamba.mamba_forward(p, x, c2)[0].numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=2e-3, atol=2e-3)


def test_mamba_is_causal():
    cfg = _cfg()
    p = _own(cfg)
    x = torch.randn(1, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    x2 = x.clone()
    x2[:, 12:] += 2.0
    with torch.no_grad():
        y1, _ = mamba.mamba_forward(p, x, cfg)
        y2, _ = mamba.mamba_forward(p, x2, cfg)
    np.testing.assert_allclose(y1[:, :12].numpy(), y2[:, :12].numpy(),
                               atol=1e-4)


# ------------------------------------------------------------- stacks

def _stack_cfgs(name, **over):
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_arch as jget_arch
    cfg = dataclasses.replace(reduced(get_arch(name)), **over)
    jcfg = dataclasses.replace(jreduced(jget_arch(name)), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _stack_params(jcfg, seed=0):
    jax, jnp = _jax()
    from repro.models import Model as JModel
    pn = _moved(jax, JModel(jcfg).init(jax.random.key(seed)),
                np.random.RandomState(seed))
    return pn, jax.tree.map(jnp.asarray, pn)


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# mamba2 reduced (a dense MLP of d_ff 512 a layer, as ``reduced`` sizes it)
# and with its published d_ff of 0 (no MLP); Jamba at 8 layers keeps its
# whole period: 7 Mamba layers, attention at offset 4, MoE on the odd
# layers; at the reduced default (2 layers) its period is 2
STACKS = [("mamba2-1.3b", {}), ("mamba2-1.3b", {"d_ff": 0}),
          ("jamba-1.5-large-398b", {}),
          ("jamba-1.5-large-398b", {"n_layers": 8, "attn_every": 8,
                                    "attn_offset": 4})]


@pytest.mark.parametrize("arch,over", STACKS)
def test_ssm_stack_forward_prefill_and_decode_match_jax(arch, over):
    _, jnp = _jax()
    from repro.models import transformer as jtr
    cfg, jcfg = _stack_cfgs(arch, **over)
    pn, jp = _stack_params(jcfg)
    params = lm_params_from_numpy(pn, cfg)
    kinds = transformer.layer_kinds(cfg)
    assert sum(k == "mamba" for k, _ in kinds) == (
        cfg.n_layers if arch.startswith("mamba") else cfg.n_layers - cfg
        .n_layers // cfg.attn_every)
    if arch.startswith("mamba"):
        assert all(lp.mlp_kind == ("dense" if cfg.d_ff else None)
                   for lp in params.blocks)
    rng = np.random.RandomState(7)
    B, T, S, steps = 2, 40, 46, 4
    toks = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    with torch.no_grad():
        logits, caches = transformer.prefill(params, torch.from_numpy(toks),
                                             cfg, S)
        full, aux = transformer.forward(params, torch.from_numpy(toks), cfg)
    jlogits, jcaches = jtr.prefill(jp, jnp.asarray(toks), jcfg, S)
    jfull, jaux = jtr.forward(jp, jnp.asarray(toks), jcfg, remat=False)
    assert _rel(logits, jlogits) <= LOGIT_REL
    assert _rel(full, jfull) <= LOGIT_REL
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    p = cfg.pattern_period
    for i, (c, (kind, _)) in enumerate(zip(caches, kinds)):
        jc = {k: v[i // p] for k, v in jcaches[i % p].items()}
        if kind == "mamba":
            assert _rel(c["ssm"], jc["ssm"]) <= STACK_REL
            assert _rel(c["conv"], jc["conv"]) <= STACK_REL
    for i in range(steps):
        tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        with torch.no_grad():
            got, caches = transformer.decode_step(
                params, torch.from_numpy(tok), caches, T + i, cfg)
        want, jcaches = jtr.decode_step(jp, jnp.asarray(tok), jcaches,
                                        jnp.asarray(T + i, jnp.int32), jcfg)
        assert _rel(got, want) <= STACK_REL


def test_init_caches_hold_a_bf16_conv_state_per_mamba_layer():
    cfg, _ = _stack_cfgs("jamba-1.5-large-398b", n_layers=8, attn_every=8,
                         attn_offset=4)
    caches = Model(cfg, device="cpu").init_caches(2, 16)
    mc = cfg.mamba
    for c, (kind, _) in zip(caches, transformer.layer_kinds(cfg)):
        if kind == "mamba":
            assert c["ssm"].shape == (2, mc.n_heads(cfg.d_model),
                                      mc.head_dim, mc.d_state)
            assert c["ssm"].dtype == torch.float32
            assert c["conv"].dtype == torch.bfloat16
        else:
            assert set(c) == {"k", "v"}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch,over", STACKS)
def test_ssm_stack_loss_and_gradients_match_jax(arch, over, remat):
    jax, jnp = _jax()
    from repro.models import Model as JModel
    cfg, jcfg = _stack_cfgs(arch, **over)
    pn, jp = _stack_params(jcfg, 1)
    toks = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 41)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jmets), jgrads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                    remat=remat), has_aux=True)(jp)
    params = lm_params_from_numpy(pn, cfg)
    params.requires_grad_(True)
    loss, mets = Model(cfg, device="cpu").loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        remat=remat)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(mets["aux"].detach()) == pytest.approx(
        float(jmets["aux"]), rel=1e-5)
    got = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), lm_tree(dict(zip(names, grads)), cfg)))
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= STACK_REL


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_stack_greedy_generate_matches_jax(arch):
    _, jnp = _jax()
    from repro.launch.serve import generate as jgenerate
    from repro.models import Model as JModel
    cfg, jcfg = _stack_cfgs(arch)
    pn, jp = _stack_params(jcfg, 2)
    B, T0, n_new = 2, 12, 6
    prompts = np.random.RandomState(8).randint(
        0, cfg.vocab_size, (B, T0)).astype(np.int32)
    want = np.asarray(jgenerate(JModel(jcfg), jp, jnp.asarray(prompts),
                                n_new, cache_len=T0 + n_new))
    steps = []
    got = generate(Model(cfg, device="cpu"), lm_params_from_numpy(pn, cfg),
                   torch.from_numpy(prompts), n_new, cache_len=T0 + n_new,
                   step_logits=steps).numpy()
    assert got.shape == want.shape
    for b in range(B):
        for i in range(n_new):
            if got[b, T0 + i] != want[b, T0 + i]:
                top2 = torch.topk(steps[i][b], 2).values
                assert float(top2[0] - top2[1]) <= STACK_REL * float(
                    steps[i][b].abs().max())
                break


def test_prefill_then_decode_equals_a_longer_prefill():
    """mamba2's prefill over T + 1 tokens against prefill(T) plus one
    decode step: the same model, chunked against recurrent (the states
    are f32; the tolerance is the property test's 5e-3)."""
    cfg, _ = _stack_cfgs("mamba2-1.3b")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = transformer.prefill(params, toks, cfg)
        _, caches = transformer.prefill(params, toks[:, :32], cfg)
        got, _ = transformer.decode_step(params, toks[:, 32:], caches, 32,
                                         cfg)
    assert _rel(got, want) <= 5e-3


def test_jamba_checkpoints_cross_between_the_packages(tmp_path):
    """A reference-written (params, AdamW state) of reduced Jamba restores
    into the port bit for bit, and the port's write restores into the
    reference bit for bit, with the same manifest."""
    jax, jnp = _jax()
    from repro.checkpoint import restore as jrestore, save as jsave
    from repro.optim import adamw as jadamw
    cfg, jcfg = _stack_cfgs("jamba-1.5-large-398b")
    pn, jp = _stack_params(jcfg, 4)
    jst = jadamw(1e-3).init(jp)
    jst = jax.tree.map(lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype)
                       .reshape(a.shape) / max(a.size, 1), jst)
    jsave(str(tmp_path / "ref"), 7, (jp, jst))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    ost = adamw(1e-3).init(list(params.parameters()))
    tree, step, _ = checkpoint.restore(
        str(tmp_path / "ref"), train.checkpoint_tree(params, ost, cfg))
    assert step == 7
    ost = train.load_checkpoint_tree(tree, params, ost, cfg)
    back = train.checkpoint_tree(params, ost, cfg)
    want = [np.asarray(v) for v in jax.tree.leaves((jp, jst))]
    got = [np.asarray(v) for v in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), back))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    checkpoint.save(str(tmp_path / "port"), 9, back)
    manifests = [json.loads((tmp_path / d / f"step_0000000{s}" /
                             "manifest.json").read_text())
                 for d, s in (("port", 9), ("ref", 7))]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert manifests[0]["shapes"] == manifests[1]["shapes"]
    assert any("/mamba/A_log" in k for k in manifests[0]["keys"])
    assert any("/moe/router" in k for k in manifests[0]["keys"])
    jtree, jstep, _ = jrestore(str(tmp_path / "port"), (jp, jst))
    assert jstep == 9
    for g, w in zip(jax.tree.leaves(jtree), want):
        np.testing.assert_array_equal(np.asarray(g), w)
