"""The port's MoE MLP (``models/moe.py``) and the MoE stacks (qwen3-moe,
llama4-scout) against the JAX package's, on the CPU.

Inputs come from a numpy seed; the reference's params are carried across
as numpy (``jax.random`` inits cannot be drawn by ``torch.Generator``).
Tolerances, each with its reason:

* ``capacity``, ``_topk_iterative`` on the same probabilities, and the
  dispatch handed the same picks: exact (integer arithmetic, argmax and a
  copy);
* ``moe_apply`` in lockstep (handed the reference's picks): rtol/atol
  ``TOL`` (1e-5), f32 products in two libraries' orders; the aux loss
  rtol 1e-5;
* the port's own routing: every pick that differs from the reference's
  must be a near-tie, the two experts' router probabilities within
  ``NEAR_TIE`` (1e-6, a few f32 rounding steps of a probability below 1);
* stacks: prefill and forward logits within ``LOGIT_REL`` (1e-5) of the
  largest |logit|, decode within ``DECODE_REL`` (2e-4; the bf16 KV caches
  may round a value to the other neighbour), gradients within
  ``GRAD_REL`` (1e-4) of each leaf's largest, as in
  ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``.

Each test imports JAX and the JAX package inside itself; the card tests
(``cuda`` marker) need neither.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ArchConfig, MoEConfig, reduced  # noqa
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_tree  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import Model, moe, transformer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NEAR_TIE = 1e-6
LOGIT_REL = 1e-5
DECODE_REL = 2e-4
GRAD_REL = 1e-4
MOE_ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e")


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _cfg(E=4, K=2, cf=2.0, d=32, f=64, act="silu"):
    return ArchConfig(name="e", family="moe", source="", n_layers=1,
                      d_model=d, n_heads=2, n_kv_heads=2, d_ff=f,
                      vocab_size=64, act=act,
                      moe=MoEConfig(num_experts=E, top_k=K, d_ff_expert=f,
                                    capacity_factor=cf))


def _jcfg(cfg):
    from repro.configs.base import ArchConfig as JA, MoEConfig as JM
    d = dataclasses.asdict(cfg)
    d["moe"] = JM(**d["moe"])
    return JA(**d)


def _params(cfg, seed):
    """(numpy params, the port's ParameterDict)."""
    rng = np.random.RandomState(seed)
    m, d = cfg.moe, cfg.d_model
    pn = {"router": rng.randn(d, m.num_experts).astype(np.float32),
          "w_gate": (rng.randn(m.num_experts, d, m.d_ff_expert)
                     / np.sqrt(d)).astype(np.float32),
          "w_up": (rng.randn(m.num_experts, d, m.d_ff_expert)
                   / np.sqrt(d)).astype(np.float32),
          "w_down": (rng.randn(m.num_experts, m.d_ff_expert, d)
                     / np.sqrt(m.d_ff_expert)).astype(np.float32)}
    port = moe.moe_init(None, cfg)
    with torch.no_grad():
        for k, t in port.items():
            t.copy_(torch.from_numpy(pn[k]))
    return pn, port


# (E, K, capacity factor, T): top-8, top-2 and top-1, with drops (a factor
# below 1) and without (one large enough that no expert overflows)
MOE_CASES = [(16, 8, 0.5, 24), (16, 8, 16.0, 24), (4, 2, 0.5, 32),
             (4, 2, 4.0, 32), (4, 1, 0.5, 32), (4, 1, 4.0, 32)]


@pytest.mark.parametrize("E,K,cf,T", MOE_CASES + [(128, 8, 1.25, 512),
                                                  (128, 8, 1.25, 1),
                                                  (16, 1, 1.25, 3)])
def test_capacity_matches_jax(E, K, cf, T):
    from repro.models import moe as jmoe
    cfg = _cfg(E, K, cf)
    assert moe.capacity(cfg.moe, T) == jmoe.capacity(_jcfg(cfg).moe, T)
    if (E, K, T) == (128, 8, 512):
        assert moe.capacity(cfg.moe, T) == 40     # qwen3-moe's prefill
    if T == 1:
        assert moe.capacity(cfg.moe, T) == K      # decode drops nothing


@pytest.mark.parametrize("k", [1, 2, 8])
def test_topk_iterative_matches_jax_with_ties(k):
    _, jnp = _jax()
    from repro.models import moe as jmoe
    rng = np.random.RandomState(k)
    probs = rng.dirichlet(np.ones(16), size=(3, 7)).astype(np.float32)
    # exact ties: the first of equal maxima wins in both packages
    probs[0, :, 5] = probs[0, :, 2]
    probs[1, :, :] = 1.0 / 16
    v, i = moe._topk_iterative(torch.from_numpy(probs), k)
    jv, ji = jmoe._topk_iterative(jnp.asarray(probs), k)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i[1, 0].numpy(), np.arange(k))


@pytest.mark.parametrize("E,K,cf,T", MOE_CASES)
def test_dispatch_row_matches_jax_on_the_same_picks(E, K, cf, T):
    _, jnp = _jax()
    from repro.models import moe as jmoe
    cfg = _cfg(E, K, cf)
    rng = np.random.RandomState(E + K)
    x = rng.randn(T, cfg.d_model).astype(np.float32)
    probs = rng.dirichlet(np.ones(E), size=T).astype(np.float32)
    _, idx = jmoe._topk_iterative(jnp.asarray(probs), K)
    cap = jmoe.capacity(_jcfg(cfg).moe, T)
    want = jmoe._dispatch_row(jnp.asarray(x), idx, _jcfg(cfg).moe, cap)
    got = moe._dispatch_row(torch.from_numpy(x),
                            torch.from_numpy(np.array(idx)), cfg.moe, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = int((~got[0]).sum())
    assert (dropped > 0) == (cf < 1.0)


def _picks_tie(own, ref, probs):
    """Every pick of the port's own routing that differs from the
    reference's is a near-tie in the router probability.  Returns the
    count of differing picks."""
    diff = own != ref
    for b, t, k in zip(*np.nonzero(diff)):
        p = probs[b, t]
        assert abs(p[own[b, t, k]] - p[ref[b, t, k]]) <= NEAR_TIE
    return int(diff.sum())


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("E,K,cf,T", MOE_CASES)
def test_moe_apply_matches_jax(E, K, cf, T, act):
    jax, jnp = _jax()
    from repro.models import moe as jmoe
    cfg = _cfg(E, K, cf, act=act)
    jcfg = _jcfg(cfg)
    pn, port = _params(cfg, 3)
    jp = {k: jnp.asarray(v) for k, v in pn.items()}
    x = np.random.RandomState(4).randn(2, T, cfg.d_model).astype(np.float32)
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, act)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"], -1))
    _, jidx = jmoe._topk_iterative(jnp.asarray(probs), K)
    jidx = np.array(jidx)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        # lockstep: handed the reference's picks
        got, aux = moe.moe_apply(port, xt, cfg, act,
                                 expert_idx=torch.from_numpy(jidx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert float(aux) == pytest.approx(float(waux), rel=1e-5)
        # the port's own routing
        _, _, own = moe.route(port, xt, cfg.moe)
        mine, maux = moe.moe_apply(port, xt, cfg, act)
    if _picks_tie(own.numpy(), jidx, probs) == 0:
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), **TOL)
        assert float(maux) == pytest.approx(float(waux), rel=1e-5)
    keep, _ = moe._slots(own, cfg.moe, moe.capacity(cfg.moe, T))
    assert bool((~keep).any()) == (cf < 1.0)


@pytest.mark.parametrize("E,K,cf,T", [(16, 8, 0.5, 24), (4, 2, 4.0, 32),
                                      (4, 1, 4.0, 32)])
def test_moe_apply_gradients_match_jax(E, K, cf, T):
    """Gradients of every leaf and of x against ``jax.grad``.  At top-1
    the router's leaf is left out: the gate is v / (v + 1e-9), whose
    derivative both packages form as 1/(v+e) - v/(v+e)^2, two nearly equal
    f32 terms, so each holds its own rounding noise there (its true value,
    1e-9/v^2, is below f32's resolution of either term)."""
    jax, jnp = _jax()
    from repro.models import moe as jmoe
    cfg = _cfg(E, K, cf)
    jcfg = _jcfg(cfg)
    pn, port = _params(cfg, 5)
    x = np.random.RandomState(6).randn(2, T, cfg.d_model).astype(np.float32)
    w = np.random.RandomState(7).randn(2, T, cfg.d_model).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(out * w) + aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in pn.items()}, jnp.asarray(x))
    port.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(port, xt, cfg)
    loss = torch.sum(out * torch.from_numpy(w)) + aux
    names = list(port.keys())
    grads = torch.autograd.grad(loss, [port[k] for k in names] + [xt])
    for name, g in zip(names + ["x"], grads):
        if K == 1 and name == "router":
            continue
        want = np.asarray(jgx if name == "x" else jg[name])
        rel = float(np.abs(g.numpy() - want).max()) / float(
            np.abs(want).max())
        assert rel <= GRAD_REL, (name, rel)


# ------------------------------------ the JAX package's own properties

def test_moe_output_finite_and_shaped():
    cfg = _cfg()
    _, p = _params(cfg, 0)
    x = torch.randn(3, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    out, aux = moe.moe_apply(p, x, cfg)
    assert out.shape == x.shape
    assert not bool(torch.isnan(out).any())
    assert float(aux) >= 0


def test_moe_aux_loss_penalizes_imbalance():
    """A router collapsed onto one expert has a larger aux loss than a
    uniform router (Switch load-balance objective)."""
    cfg = _cfg(E=4, K=1)
    _, p = _params(cfg, 0)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        p["router"].zero_()
        _, aux_u = moe.moe_apply(p, x, cfg)
        p["router"][:, 0] = 50.0
        _, aux_c = moe.moe_apply(p, x, cfg)
    assert float(aux_c) > float(aux_u)


def test_moe_capacity_drops_dont_nan():
    cfg = _cfg(E=4, K=2, cf=0.25)                # forces drops
    _, p = _params(cfg, 0)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    out, _ = moe.moe_apply(p, x, cfg)
    assert not bool(torch.isnan(out).any())
    _, _, idx = moe.route(p, x, cfg.moe)
    assert not moe._slots(idx, cfg.moe, moe.capacity(cfg.moe, 32))[0].all()


def test_moe_respects_capacity():
    cfg = _cfg(E=2, K=1)
    assert 1 <= moe.capacity(cfg.moe, 16) <= 16


def test_moe_dispatch_conservation():
    """With ample capacity every (token, expert) assignment is dispatched
    exactly once and the combine gives the pure top-k mixture of a dense
    (no-dispatch) oracle."""
    cfg = _cfg(E=4, K=2)
    _, p = _params(cfg, 0)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        out, _ = moe.moe_apply(p, x, cfg)
        probs = torch.softmax(x @ p["router"], dim=-1)
        gates, idx = moe._topk_iterative(probs, 2)
        gates = gates / gates.sum(-1, keepdim=True)
        ys = torch.stack([
            (torch.nn.functional.silu(x @ p["w_gate"][e])
             * (x @ p["w_up"][e])) @ p["w_down"][e] for e in range(4)])
        want = torch.zeros_like(x)
        for k in range(2):
            sel = torch.gather(ys.permute(1, 2, 0, 3), 2,
                               idx[..., k].long()[..., None, None]
                               .expand(2, 16, 1, cfg.d_model))[..., 0, :]
            want = want + gates[..., k][..., None] * sel
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)


def test_moe_topk_iterative_matches_torch_topk_without_ties():
    probs = torch.softmax(torch.randn(3, 7, 16, generator=torch.Generator()
                                      .manual_seed(5)), dim=-1)
    v1, i1 = moe._topk_iterative(probs, 4)
    v2, i2 = torch.topk(probs, 4)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())


# ------------------------------------------------------------- stacks

def _stack_cfgs(name, **over):
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_arch as jget_arch
    cfg = dataclasses.replace(reduced(get_arch(name)), **over)
    jcfg = dataclasses.replace(jreduced(jget_arch(name)), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _stack_params(jcfg, seed=0):
    """(numpy params, jnp params) from the reference's init, norms moved
    off zero so that they count."""
    jax, jnp = _jax()
    from repro.models import Model as JModel
    rng = np.random.RandomState(seed)

    def one(path, a):
        a = np.asarray(a)
        if "norm" in jax.tree_util.keystr(path):
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    pn = jax.tree_util.tree_map_with_path(
        one, JModel(jcfg).init(jax.random.key(seed)))
    return pn, jax.tree.map(jnp.asarray, pn)


def _rel(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_stack_forward_prefill_and_decode_match_jax(arch):
    _, jnp = _jax()
    from repro.models import transformer as jtr
    cfg, jcfg = _stack_cfgs(arch)
    pn, jp = _stack_params(jcfg)
    params = lm_params_from_numpy(pn, cfg)
    assert all(lp.mlp_kind == "moe" for lp in params.blocks)
    rng = np.random.RandomState(7)
    B, T, S, steps = 2, 24, 30, 4
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
    assert float(aux) > 0
    for i in range(steps):
        tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        with torch.no_grad():
            got, caches = transformer.decode_step(
                params, torch.from_numpy(tok), caches, T + i, cfg)
        want, jcaches = jtr.decode_step(jp, jnp.asarray(tok), jcaches,
                                        jnp.asarray(T + i, jnp.int32), jcfg)
        assert _rel(got, want) <= DECODE_REL


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_stack_loss_and_gradients_match_jax(arch, remat):
    jax, jnp = _jax()
    from repro.models import Model as JModel
    cfg, jcfg = _stack_cfgs(arch)
    pn, jp = _stack_params(jcfg, 1)
    toks = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 25)).astype(np.int32)
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
    assert float(mets["aux"]) == pytest.approx(float(jmets["aux"]), rel=1e-5)
    assert float(mets["aux"]) > 0
    got = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), lm_tree(dict(zip(names, grads)), cfg)))
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_REL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_stack_greedy_generate_matches_jax(arch):
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
                # a split only at a near-tie; the sequences then differ
                top2 = torch.topk(steps[i][b], 2).values
                assert float(top2[0] - top2[1]) <= DECODE_REL * float(
                    steps[i][b].abs().max())
                break


# ------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("E,K,cf,T", [(128, 8, 1.25, 64), (16, 2, 0.5, 64)])
def test_moe_layer_on_card_matches_cpu(E, K, cf, T):
    """One MoE layer at qwen3-moe's width (d 2048, 128 experts of 768,
    top-8) and with drops, on the card against the CPU on the same
    weights, TF32 off: the card's own picks tie the CPU's, and the
    outputs agree within rtol/atol 1e-5 in lockstep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = _cfg(E, K, cf, d=2048, f=768)
        p = moe.moe_init(torch.Generator("cuda").manual_seed(0), cfg,
                         device="cuda")
        cpu = moe.moe_init(None, cfg)
        cpu.load_state_dict(p.state_dict())
        x = torch.randn(2, T, cfg.d_model, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
        with torch.no_grad():
            probs, _, idx = moe.route(cpu, x.cpu(), cfg.moe)
            _, _, own = moe.route(p, x, cfg.moe)
            _picks_tie(own.cpu().numpy(), idx.numpy(), probs.numpy())
            got, aux = moe.moe_apply(p, x, cfg, expert_idx=idx.cuda())
            want, waux = moe.moe_apply(cpu, x.cpu(), cfg, expert_idx=idx)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
        assert float(aux) == pytest.approx(float(waux), rel=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
