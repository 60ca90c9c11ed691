"""The port's encoder-decoder stack (``models/encdec.py``, whisper-base)
against the JAX package's, on the CPU.

Inputs (frames and tokens) come from a numpy seed; the reference's params
are carried across with ``convert.lm_params_from_numpy``, norms moved off
zero so that they count.  Tolerances, each with its reason:

* ``encode`` and ``_cross_attn``: rtol/atol ``TOL`` (2e-5), f32 products
  through an attention and an MLP per layer in two libraries' orders (the
  attention tolerance of ``tests/test_torch_lm.py``);
* prefill and forward logits within ``LOGIT_REL`` (1e-5) of the largest
  |logit|; decode within ``DECODE_REL`` (2e-4): the self and cross caches
  are bf16, and a value may round to the other neighbour;
* the bf16 caches: the reference's bits on all but 1% of entries; the
  rest within one bf16 step plus ``STRADDLE`` (1e-6) of the tensor's
  largest magnitude, the size of the two libraries' f32 differences in a
  product (near zero they move a value by more than its own bf16 step),
  as in ``tests/test_torch_lm.py``;
* gradients within ``GRAD_REL`` (1e-4) of each leaf's largest, as in
  ``tests/test_torch_train.py``; checkpoints read back bit for bit.

Each test imports JAX and the JAX package inside itself; the card test
(``cuda`` marker) needs neither.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_tree  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import Model, attention, encdec  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_REL = 1e-5
DECODE_REL = 2e-4
GRAD_REL = 1e-4
STRADDLE = 1e-6
ARCH = "whisper-base"


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


def _cfgs(**over):
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_arch as jget_arch
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), **over)
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _params(jcfg, seed=0):
    """(numpy params, jnp params) from the reference's init."""
    jax, jnp = _jax()
    from repro.models import encdec as jed
    rng = np.random.RandomState(seed)

    def one(path, a):
        a = np.asarray(a)
        if "norm" in jax.tree_util.keystr(path):
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a
    pn = jax.tree_util.tree_map_with_path(
        one, jed.init_params(jax.random.key(seed), jcfg))
    return pn, jax.tree.map(jnp.asarray, pn)


def _frames(cfg, B, seed):
    return np.random.RandomState(seed).randn(
        B, cfg.encoder_seq, cfg.d_model).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _bf16_close(got, want):
    """bf16 tensors: equal bits but on < 1% of entries, and there within
    one bf16 step (bf16 keeps 8 bits) plus ``STRADDLE`` of the largest
    magnitude."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    assert (g != w).mean() < 1e-2
    d = STRADDLE * float(np.abs(w).max())
    assert (np.abs(g - w) <= np.spacing(np.abs(w)) * 2.0 ** 16 + d).all()


def test_layout_and_param_names_follow_the_reference():
    cfg, jcfg = _cfgs()
    pn, _ = _params(jcfg)
    params = lm_params_from_numpy(pn, cfg)
    assert isinstance(params, encdec.EncDec)
    names = [n for n, _ in params.named_parameters()]
    assert "enc_pos" in names and "dec_layers.1.xattn.wk" in names
    assert len(params.enc_layers) == cfg.n_encoder_layers
    tree = lm_tree(dict(params.named_parameters()), cfg)
    jax, _ = _jax()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, tree)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, pn))
    for g, w in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.detach().numpy(), tree)), jax.tree.leaves(pn)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_encode_and_cross_attn_match_jax():
    _, jnp = _jax()
    from repro.models import encdec as jed
    cfg, jcfg = _cfgs()
    pn, jp = _params(jcfg, 1)
    params = lm_params_from_numpy(pn, cfg)
    frames = _frames(cfg, 2, 2)
    with torch.no_grad():
        enc = encdec.encode(params, torch.from_numpy(frames), cfg)
    jenc = jed.encode(jp, jnp.asarray(frames), jcfg)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    # cross-attention over the encoder's keys and values, f32 (prefill)
    # and bf16 (decode's caches)
    x = np.random.RandomState(3).randn(2, 5, cfg.d_model).astype(np.float32)
    lp, jlp = params.dec_layers[0].xattn, jp["dec_layers"]["xattn"]
    jlp = {k: v[0] for k, v in jlp.items()}
    jk, jv = jed.enc_kv(jlp, jenc, jcfg)
    with torch.no_grad():
        k, v = encdec.enc_kv(lp, enc, cfg)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
        for dt in (torch.float32, torch.bfloat16):
            kv = (torch.from_numpy(np.array(jk, np.float32)).to(dt),
                  torch.from_numpy(np.array(jv, np.float32)).to(dt))
            jkv = (jnp.asarray(kv[0].float().numpy()).astype(
                jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32),
                jnp.asarray(kv[1].float().numpy()).astype(
                jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32))
            got = encdec._cross_attn(lp, torch.from_numpy(x), kv, cfg)
            want = jed._cross_attn(jlp, jnp.asarray(x), jkv, jcfg)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_jax():
    _, jnp = _jax()
    from repro.models import encdec as jed
    cfg, jcfg = _cfgs()
    pn, jp = _params(jcfg, 4)
    params = lm_params_from_numpy(pn, cfg)
    rng = np.random.RandomState(5)
    B, T, S, steps = 2, 20, 26, 5
    frames = _frames(cfg, B, 6)
    toks = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    with torch.no_grad():
        logits, caches = encdec.prefill(params, torch.from_numpy(frames),
                                        torch.from_numpy(toks), cfg, S)
    jlogits, jcaches = jed.prefill(jp, jnp.asarray(frames), jnp.asarray(toks),
                                   jcfg, S)
    assert _rel(logits, jlogits) <= LOGIT_REL
    for i in range(cfg.n_layers):
        for part in ("self", "cross"):
            for key in ("k", "v"):
                c = caches[part][i][key]
                assert c.dtype == torch.bfloat16
                _bf16_close(c, np.asarray(jcaches[part][key][i], np.float32))
    assert caches["cross"][0]["k"].shape == (B, cfg.encoder_seq,
                                             cfg.n_heads, 32)
    for i in range(steps):
        tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        with torch.no_grad():
            got, caches = encdec.decode_step(params, torch.from_numpy(tok),
                                             caches, T + i, cfg)
        want, jcaches = jed.decode_step(jp, jnp.asarray(tok), jcaches,
                                        jnp.asarray(T + i, jnp.int32), jcfg)
        assert _rel(got, want) <= DECODE_REL
    # init_caches: the reference's shapes and dtype, one dict a layer
    zc = Model(cfg, device="cpu").init_caches(B, S)
    jz = jed.init_caches(jcfg, B, S)
    for part in ("self", "cross"):
        assert len(zc[part]) == cfg.n_layers
        for key in ("k", "v"):
            assert tuple(zc[part][0][key].shape) == jz[part][key].shape[1:]
            assert zc[part][0][key].dtype == torch.bfloat16


@pytest.mark.parametrize("remat", [True, False])
def test_forward_loss_and_gradients_match_jax(remat):
    jax, jnp = _jax()
    from repro.models import Model as JModel
    cfg, jcfg = _cfgs()
    pn, jp = _params(jcfg, 7)
    toks = np.random.RandomState(8).randint(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"frames": _frames(cfg, 2, 9), "tokens": toks[:, :-1],
             "labels": toks[:, 1:]}
    with torch.no_grad():
        full, aux = encdec.forward(lm_params_from_numpy(pn, cfg),
                                   torch.from_numpy(batch["frames"]),
                                   torch.from_numpy(batch["tokens"]), cfg)
    from repro.models import encdec as jed
    jfull, _ = jed.forward(jp, jnp.asarray(batch["frames"]),
                           jnp.asarray(batch["tokens"]), jcfg, remat=False)
    assert _rel(full, jfull) <= LOGIT_REL and float(aux) == 0.0
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
    assert float(mets["aux"]) == float(jmets["aux"]) == 0.0
    got = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), lm_tree(dict(zip(names, grads)), cfg)))
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= GRAD_REL


def test_greedy_generate_matches_jax():
    _, jnp = _jax()
    from repro.launch.serve import generate as jgenerate
    from repro.models import Model as JModel
    cfg, jcfg = _cfgs()
    pn, jp = _params(jcfg, 10)
    B, T0, n_new = 2, 8, 6
    prompts = np.random.RandomState(11).randint(
        0, cfg.vocab_size, (B, T0)).astype(np.int32)
    frames = _frames(cfg, B, 12)
    want = np.asarray(jgenerate(JModel(jcfg), jp, jnp.asarray(prompts),
                                n_new, cache_len=T0 + n_new,
                                frames=jnp.asarray(frames)))
    steps = []
    got = generate(Model(cfg, device="cpu"), lm_params_from_numpy(pn, cfg),
                   torch.from_numpy(prompts), n_new, cache_len=T0 + n_new,
                   frames=torch.from_numpy(frames), step_logits=steps).numpy()
    assert got.shape == want.shape
    for b in range(B):
        for i in range(n_new):
            if got[b, T0 + i] != want[b, T0 + i]:
                top2 = torch.topk(steps[i][b], 2).values
                assert float(top2[0] - top2[1]) <= DECODE_REL * float(
                    steps[i][b].abs().max())
                break


def test_encoder_takes_the_full_mode_kernel_outside_autograd(monkeypatch):
    """A prefill calls ``ops.flash_attention`` once per encoder layer with
    ``causal=False`` and once per decoder layer with ``causal=True`` (on
    the CPU the kernel's plain version answers); under autograd no call
    reaches it."""
    cfg, _ = _cfgs()
    params = encdec.init_params(torch.Generator().manual_seed(0), cfg)
    calls = []
    flash = ops.flash_attention

    def counted(*a, **k):
        calls.append(k["causal"])
        return flash(*a, **k)
    monkeypatch.setattr(ops, "flash_attention", counted)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(2))
    before = dict(attention.ROUTES)
    with torch.no_grad():
        encdec.prefill(params, frames, toks, cfg, 12)
    assert calls == [False] * cfg.n_encoder_layers + [True] * cfg.n_layers
    assert attention.ROUTES["flash"] - before["flash"] == \
        cfg.n_encoder_layers + cfg.n_layers
    calls.clear()
    params.requires_grad_(True)
    loss, _ = encdec.loss_fn(params, {"frames": frames, "tokens": toks,
                                      "labels": toks}, cfg, remat=False)
    torch.autograd.grad(loss, list(params.parameters()))
    assert calls == []
    # the full-mode plain version is the encoder's chunked softmax
    q, k, v = (torch.randn(2, 3, 40, 16, generator=torch.Generator()
                           .manual_seed(s)) for s in (3, 4, 5))
    pos = torch.arange(40, dtype=torch.int32)
    want = attention._sdpa_chunked(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), pos, pos,
        causal=False, window=0, attn_cap=0.0).transpose(1, 2)
    np.testing.assert_allclose(
        ref.flash_attention_ref(q, k, v, causal=False).numpy(),
        want.numpy(), rtol=1e-5, atol=1e-5)


def test_whisper_checkpoints_cross_between_the_packages(tmp_path):
    """A reference-written (params, AdamW state) of reduced whisper-base
    restores into the port bit for bit, and the port's write restores into
    the reference bit for bit, with the same manifest."""
    jax, jnp = _jax()
    from repro.checkpoint import restore as jrestore, save as jsave
    from repro.optim import adamw as jadamw
    cfg, jcfg = _cfgs()
    pn, jp = _params(jcfg, 13)
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
    assert "0/enc_layers/attn/wq" in manifests[0]["keys"]
    assert "1/m/dec_layers/xattn/wk" in manifests[0]["keys"]
    jtree, jstep, _ = jrestore(str(tmp_path / "port"), (jp, jst))
    assert jstep == 9
    for g, w in zip(jax.tree.leaves(jtree), want):
        np.testing.assert_array_equal(np.asarray(g), w)


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_full_mode_flash_at_the_encoder_shape_on_card():
    """whisper-base's encoder attention on the card: B*H = 4*8, T = 1500,
    d = 64, f32, ``causal=False``, through the kernel against its plain
    version on the same inputs, TF32 off (the kernel's split TF32 holds
    the f32 tolerance of 2e-4 that phase 3 of ``chip_smoke.py`` uses)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch(ARCH)
        hd = cfg.resolved_head_dim
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v = (torch.randn(4, cfg.n_heads, cfg.encoder_seq, hd,
                               device="cuda", generator=g) for _ in range(3))
        before = ops.LAUNCHES["flash_attention"]
        got = ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention"] == before + 1
        want = ref.flash_attention_ref(q, k, v, causal=False)
        assert math.isfinite(float(got.abs().max()))
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
