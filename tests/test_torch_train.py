"""The port's LM training (loss, remat, optimizers, schedules, the Markov
stream, checkpoints, ``launch/train.py``) against the JAX package's, on
the CPU.

Weights are the reference's init carried across
(``convert.lm_params_from_numpy``, norms and biases moved off zero so that
their gradients count).  Tolerances, each with its reason:

* ``cross_entropy`` and the loss: rtol 1e-5, f32 sums in two orders;
* gradients: within ``GRAD_REL`` (1e-4) of each leaf's largest magnitude,
  the same rounding carried through the backward pass of the chunked
  softmax, remat or not;
* optimizers and schedules on identical inputs: rtol/atol ``OPT_TOL``
  (1e-6): the same f32 formulas, the global norm summed in another order;
* ``train_loop``: every loss within ``LOSS_REL`` (1e-4) relative over 5
  steps, params within ``PARAM_TOL`` (1e-4) absolute after them: Adam
  divides by sqrt(v) + 1e-8, which amplifies last-bit gradient differences
  where a gradient is near zero, so the runs are close, not bit-equal;
* the Markov stream, and checkpoints read back: bit for bit.

Each test imports JAX and the JAX package inside itself.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_tree  # noqa: E402
from repro_torch.data import pipeline, tokens  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import Model, layers  # noqa: E402
from repro_torch.optim import optimizers as optim  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "qwen2.5-3b", "gemma2-27b")
GRAD_REL = 1e-4
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_REL = 1e-4
PARAM_TOL = 1e-4


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _cfgs(name, **over):
    """(the port's, the reference's) reduced config of one arch."""
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_arch as jget_arch
    cfg = dataclasses.replace(reduced(get_arch(name)), **over)
    jcfg = dataclasses.replace(jreduced(jget_arch(name)), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _ref_params(jcfg, seed=0):
    """The reference's init as numpy, norms and biases moved off 0."""
    jax, _ = _jax()
    from repro.models import transformer as jtr
    rng = np.random.RandomState(seed)

    def one(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("norm", "'bq'", "'bk'", "'bv'")):
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(
        one, jtr.init_params(jax.random.key(seed), jcfg))


def _tree_leaves(tree):
    jax, _ = _jax()
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


# ------------------------------------------------------------------ loss

def test_cross_entropy_masks_the_padded_vocab():
    _, jnp = _jax()
    from repro.models import layers as jl
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 7, 96)).astype(np.float32)
    logits[..., 80:] += 20.0            # padding that would win unmasked
    labels = rng.randint(0, 80, (2, 7)).astype(np.int32)
    got = float(layers.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), 80))
    want = float(jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  80))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(layers.cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels), 96)) == \
        pytest.approx(float(jl.cross_entropy(jnp.asarray(logits),
                                             jnp.asarray(labels), 96)),
                      rel=1e-5)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, remat):
    jax, jnp = _jax()
    from repro.models import Model as JModel
    cfg, jcfg = _cfgs(arch)
    pn = _ref_params(jcfg)
    rng = np.random.RandomState(3)
    # T = 80 > gemma2's window of 64: its local layers mask
    toks = rng.randint(0, cfg.vocab_size, (2, 81)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jp = jax.tree.map(jnp.asarray, pn)
    (jloss, jmets), jgrads = jax.value_and_grad(
        lambda p: JModel(jcfg).loss(p, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                    remat=remat), has_aux=True)(jp)
    params = lm_params_from_numpy(pn, cfg)
    params.requires_grad_(True)
    model = Model(cfg, device="cpu")
    loss, mets = model.loss(params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, remat=remat)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(mets["ce"].detach()) == pytest.approx(float(jmets["ce"]),
                                                       rel=1e-5)
    assert float(mets["aux"]) == float(jmets["aux"]) == 0.0
    got = _tree_leaves(lm_tree(dict(zip(names, grads)), cfg))
    want = _tree_leaves(jgrads)
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        rel = float(np.abs(g - w).max()) / float(np.abs(w).max())
        worst = max(worst, rel)
        assert rel <= GRAD_REL, rel
    print(f"{arch} remat={remat}: loss {float(loss):.6f} vs "
          f"{float(jloss):.6f}, gradients within {worst:.3g} of each "
          f"leaf's largest")


# ------------------------------------------------------------ optimizers

def _opt_inputs(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.randn(*s).astype(dtype) for s in shapes]
    grads = [(0.5 * rng.randn(*s)).astype(dtype) for s in shapes]
    grads[1][:2] = 1e-9                    # near-zero gradients
    return params, grads


OPTIMIZERS = [
    ("sgd", {}), ("sgd", {"clip_norm": 0.5}), ("momentum", {}),
    ("momentum", {"momentum": 0.8, "clip_norm": 0.1}),
    ("adam", {}), ("adam", {"clip_norm": None, "b2": 0.999}),
    ("adamw", {"weight_decay": 0.01}),
    ("adamw", {"weight_decay": 0.1, "clip_norm": 0.05, "eps": 1e-6}),
]


@pytest.mark.parametrize("sched", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizers_match_jax_on_identical_inputs(name, kw, sched):
    jax, jnp = _jax()
    from repro.optim import optimizers as jopt

    def schedule(mod):
        return {"constant": lambda: 3e-3,
                "cosine": lambda: mod.cosine_schedule(3e-3, 2, 6),
                "linear": lambda: mod.linear_schedule(3e-3, 2, 6)}[sched]()
    opt = optim.get_optimizer(name, schedule(optim), **dict(kw))
    jo = jopt.get_optimizer(name, schedule(jopt), **dict(kw))
    params, _ = _opt_inputs(0)
    state = jax.tree.map(np.array, jo.init([jnp.asarray(p)
                                            for p in params]))
    for step in range(4):
        _, grads = _opt_inputs(step + 1)
        # both from the same inputs each step: the reference's
        tstate = {k: [torch.from_numpy(np.array(v)) for v in vs]
                  for k, vs in state.items()}
        new, nstate = opt.update([torch.from_numpy(g) for g in grads],
                                 [torch.from_numpy(p) for p in params],
                                 tstate, step)
        jnew, jstate = jo.update([jnp.asarray(g) for g in grads],
                                 [jnp.asarray(p) for p in params],
                                 jax.tree.map(jnp.asarray, state),
                                 jnp.asarray(step))
        for a, b in zip(new, jnew):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)
        assert set(nstate) == set(jstate)
        for k in nstate:
            for a, b in zip(nstate[k], jstate[k]):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **OPT_TOL)
        params = [np.array(p) for p in jnew]
        state = jax.tree.map(np.array, jstate)


def test_schedules_norms_and_bf16_moments_match_jax():
    jax, jnp = _jax()
    from repro.optim import optimizers as jopt
    for make in (lambda m: m.constant_schedule(1e-3),
                 lambda m: m.cosine_schedule(3e-3, 5, 100),
                 lambda m: m.cosine_schedule(1e-2, 1, 10, final_frac=0.0),
                 lambda m: m.linear_schedule(3e-3, 5, 100)):
        s, js = make(optim), make(jopt)
        for step in (0, 1, 4, 5, 6, 37, 99, 100, 150):
            got, want = float(s(step)), float(js(jnp.asarray(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    params, grads = _opt_inputs(5)
    tg = [torch.from_numpy(g) for g in grads]
    assert float(optim.global_norm(tg)) == pytest.approx(
        float(jopt.global_norm([jnp.asarray(g) for g in grads])), rel=1e-6)
    for a, b in zip(optim.clip_by_global_norm(tg, 0.3),
                    jopt.clip_by_global_norm([jnp.asarray(g)
                                              for g in grads], 0.3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)
    # bf16 params and moments: the same roundings
    opt = optim.adamw(1e-2, weight_decay=0.01, state_dtype=torch.bfloat16)
    jo = jopt.adamw(1e-2, weight_decay=0.01, state_dtype=jnp.bfloat16)
    tp = [torch.from_numpy(p).to(torch.bfloat16) for p in params]
    jp = [jnp.asarray(p, jnp.bfloat16) for p in params]
    new, st = opt.update(tg, tp, opt.init(tp), 0)
    jnew, jst = jo.update([jnp.asarray(g) for g in grads], jp, jo.init(jp),
                          jnp.asarray(0))
    for a, b in zip(new + st["m"] + st["v"],
                    list(jnew) + list(jst["m"]) + list(jst["v"])):
        assert a.dtype == torch.bfloat16
        want = np.asarray(jnp.asarray(b, jnp.float32))
        got = a.float().numpy()
        # one bf16 step where the last f32 bits decide the rounding
        step = np.spacing(np.abs(want)) * 2.0 ** 16
        assert (np.abs(got - want) <= step).all()
        assert (got != want).mean() < 0.05


# ------------------------------------------------------- tokens, placement

@pytest.mark.parametrize("seed", [0, 3])
def test_markov_stream_is_the_references_bit_for_bit(seed):
    from repro.data import tokens as jt
    for mine, ref in zip(tokens.lm_batches(97, 3, 17, 4, seed=seed),
                         jt.lm_batches(97, 3, 17, 4, seed=seed)):
        assert mine.keys() == ref.keys()
        for k in mine:
            assert mine[k].dtype == ref[k].dtype == np.int32
            np.testing.assert_array_equal(mine[k], ref[k])
    m, r = tokens.MarkovTokens(50, seed, branching=3), \
        jt.MarkovTokens(50, seed, branching=3)
    np.testing.assert_array_equal(m.next_tokens, r.next_tokens)
    np.testing.assert_array_equal(m.stream(40), r.stream(40))


def test_place_moves_batches_to_the_device():
    b = next(tokens.lm_batches(31, 2, 5, 1))
    placed = pipeline.place(b, "cpu")
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.int32
               for v in placed.values())
    got = list(pipeline.sharded_iterator(tokens.lm_batches(31, 2, 5, 2),
                                         "cpu"))
    assert len(got) == 2 and torch.equal(got[0]["tokens"], placed["tokens"])


# ------------------------------------------------------------ checkpoints

def _ref_train_state(jcfg, seed=0):
    """The reference's (params, adamw state) after init, as jnp."""
    jax, jnp = _jax()
    from repro.optim import adamw as jadamw
    jp = jax.tree.map(jnp.asarray, _ref_params(jcfg, seed))
    opt = jadamw(1e-3)
    st = opt.init(jp)
    # moments moved off zero so that their layout counts
    st = jax.tree.map(lambda a: a + 0.01 * jnp.arange(a.size, dtype=a.dtype)
                      .reshape(a.shape) / max(a.size, 1), st)
    return jp, st


def _port_train_state(cfg):
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    opt = optim.adamw(1e-3)
    return params, opt.init(list(params.parameters()))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b"])
def test_checkpoints_cross_between_the_packages(tmp_path, arch):
    jax, _ = _jax()
    from repro.checkpoint import restore as jrestore, save as jsave
    cfg, jcfg = _cfgs(arch)
    jp, jst = _ref_train_state(jcfg)
    # reference-written -> port
    jsave(str(tmp_path / "ref"), 7, (jp, jst), extra={"by": "jax"})
    params, ost = _port_train_state(cfg)
    like = train.checkpoint_tree(params, ost, cfg)
    tree, step, extra = checkpoint.restore(str(tmp_path / "ref"), like)
    assert (step, extra) == (7, {"by": "jax"})
    ost = train.load_checkpoint_tree(tree, params, ost, cfg)
    back = train.checkpoint_tree(params, ost, cfg)
    got = _tree_leaves(jax.tree.map(lambda t: t.numpy(), back))
    want = _tree_leaves((jp, jst))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # port-written -> reference
    checkpoint.save(str(tmp_path / "port"), 9, back)
    with open(tmp_path / "port" / "step_00000009" / "manifest.json") as f:
        mine = json.load(f)
    with open(tmp_path / "ref" / "step_00000007" / "manifest.json") as f:
        ref = json.load(f)
    assert mine["keys"] == ref["keys"]
    assert (mine["shapes"], mine["dtypes"]) == (ref["shapes"], ref["dtypes"])
    jtree, jstep, _ = jrestore(str(tmp_path / "port"), (jp, jst))
    assert jstep == 9
    for g, w in zip(_tree_leaves(jtree), want):
        np.testing.assert_array_equal(g, w)


def test_checkpoint_dtypes_atomic_writes_and_prune(tmp_path):
    _, jnp = _jax()
    from repro.checkpoint import restore as jrestore, save as jsave
    rng = np.random.RandomState(0)
    a = rng.randn(3, 4).astype(np.float32)
    tree = {"w": torch.from_numpy(a).to(torch.bfloat16),
            "b": [torch.arange(5, dtype=torch.int32),
                  torch.from_numpy(a[0])]}
    jtree = {"w": jnp.asarray(a, jnp.bfloat16),
             "b": [jnp.arange(5, dtype=jnp.int32), jnp.asarray(a[0])]}
    path = checkpoint.save(str(tmp_path / "p"), 1, tree)
    jsave(str(tmp_path / "j"), 1, jtree)
    with open(os.path.join(path, "manifest.json")) as f:
        mine = json.load(f)
    with open(tmp_path / "j" / "step_00000001" / "manifest.json") as f:
        ref = json.load(f)
    assert mine == ref
    assert mine["dtypes"]["w"] == "bfloat16"
    got, _, _ = checkpoint.restore(str(tmp_path / "j"), tree)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["b"][0],
                                                            tree["b"][0])
    back, _, _ = jrestore(str(tmp_path / "p"), jtree)
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  np.asarray(jtree["w"], np.float32))
    # no temporary directory is left behind; prune keeps the newest
    for s in (2, 3, 4):
        checkpoint.save(str(tmp_path / "p"), s, tree)
    assert checkpoint.latest_step(str(tmp_path / "p")) == 4
    checkpoint.prune(str(tmp_path / "p"), keep=2)
    assert sorted(os.listdir(tmp_path / "p")) == ["step_00000003",
                                                  "step_00000004"]
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), tree)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path / "p"),
                           {"w": torch.zeros(2, 2), "b": tree["b"]})


# ------------------------------------------------------------ train loop

def test_train_loop_matches_the_references(tmp_path, capsys):
    """Both packages resume from one reference-written step-0 checkpoint
    (so they start from the same weights and moments), train 5 steps on
    the same Markov stream, and write their final checkpoints; the
    reference then reads the port's."""
    jax, _ = _jax()
    from repro.checkpoint import restore as jrestore, save as jsave
    from repro.launch import train as jtrain
    cfg, jcfg = _cfgs("qwen1.5-0.5b")
    jp = jax.tree.map(np.asarray, _ref_params(jcfg))
    from repro.optim import adamw as jadamw
    jsave(str(tmp_path / "ref"), 0, (jp, jadamw(1e-3).init(jp)))
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    kw = dict(steps=5, batch=2, seq=16, lr=3e-3, log_every=1)
    jparams, jlosses = jtrain.train_loop(jcfg, ckpt_dir=str(tmp_path / "ref"),
                                         **kw)
    step_s = []
    params, losses = train.train_loop(cfg, ckpt_dir=str(tmp_path / "port"),
                                      device="cpu", step_s=step_s, **kw)
    out = capsys.readouterr().out
    assert out.count("resumed from step 0") == 2
    assert len(losses) == len(jlosses) == len(step_s) == 5
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_REL)
    print(f"losses {losses}\nref    {jlosses}")
    assert losses[-1] < losses[0]
    # the port's final checkpoint, read by the reference
    jtree, jstep, _ = jrestore(str(tmp_path / "port"),
                               (jparams, jadamw(1e-3).init(jparams)))
    assert jstep == 5
    worst = 0.0
    names = [n for n, _ in params.named_parameters()]
    mine = _tree_leaves(jax.tree.map(lambda t: t.detach().numpy(), lm_tree(
        dict(zip(names, params.parameters())), cfg)))
    for g, c, w in zip(_tree_leaves(jtree[0]), mine,
                       _tree_leaves(jparams)):
        np.testing.assert_array_equal(g, c)
        worst = max(worst, float(np.abs(g - w).max()))
    assert worst <= PARAM_TOL, worst
    print(f"params after 5 steps within {worst:.3g} of the reference's")


def test_main_runs_on_cpu_and_defaults_to_the_card(capsys):
    train.main(["--device", "cpu", "--steps", "3", "--layers", "1",
                "--d-model", "64", "--seq", "8", "--batch", "2"])
    out = capsys.readouterr().out
    assert "training qwen1.5-0.5b-smoke" in out
    assert "step     0" in out and "step     2" in out
    assert "last-10 mean loss" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--steps", "1"])
