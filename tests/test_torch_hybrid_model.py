"""The port's ssm and hybrid models (falcon-mamba-7b's and jamba-v0.1-52b's
smoke configs, and jamba at its published period, 8 layers a unit with
attention at 4 and moe on the odd layers, over two units) against the JAX
package, on the CPU: the stacked tree, ``forward``'s logits and router
loss, prefill + greedy decode, the training loss and every gradient leaf
against ``jax.grad``, ``param_count`` for every config the port builds,
the tree across the bridge in bf16, and the entry points (``serve()``,
``launch/train.py --arch``) on the CPU.

JAX's ``init_params`` crosses into the port through
``bridge.params_from_jax`` (norm scales, conv biases and skip gains made
random in numpy, so they count); tokens come from a numpy seed. fp32; JAX
at ``highest`` matmul precision (``tests/conftest.py``): within 2e-5 of
scale (``tests/test_kernels.py::_tol``), the greedy tokens equal. The
plain smoke jamba config is one unit of 2 layers; the published period over
two units is what holds the stacking over units.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.configs.base import HybridConfig as JHybrid
from repro.models import model as JM
from repro.models.runtime import Runtime as JRuntime
from repro_torch import bridge, tree
from repro_torch.configs.base import HybridConfig as THybrid
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as S
from repro_torch.launch import train as TRAIN
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.runtime import DEFAULT, Runtime

TOL = 2e-5
DECODE_TOL = 2e-4            # tests/test_models.py::test_decode_matches_forward
PROMPT, BATCH, STEPS = 9, 2, 3
FALCON, JAMBA = "falcon-mamba-7b", "jamba-v0.1-52b"
# jamba's published period at smoke widths, over two units
PERIOD = dict(n_layers=16)
CASES = ["falcon", "jamba", "jamba-period"]
# every config the port builds: the dense, moe, ssm and hybrid families
BUILT = ["stablelm-1.6b", "qwen1.5-110b", "minitron-4b", "nemotron-4-340b",
         "deepseek-moe-16b", "arctic-480b", FALCON, JAMBA]
PUBLISHED = {FALCON: (7_272_665_088, 7_272_665_088),
             JAMBA: (51_570_315_264, 12_110_303_232)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(case):
    """(JAX config, port config) of a case."""
    arch = FALCON if case == "falcon" else JAMBA
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    if case == "jamba-period":
        full = TC.get(JAMBA).hybrid
        jcfg = jcfg.replace(hybrid=JHybrid(**dataclasses.asdict(full)),
                            **PERIOD)
        tcfg = tcfg.replace(hybrid=THybrid(**dataclasses.asdict(full)),
                            **PERIOD)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(
        seed)))

    def perturb(path, a):
        key = path[-1].key
        if key in ("scale", "Dskip"):
            return (1 + rng.randn(*a.shape) * 0.1).astype(a.dtype)
        if key == "conv_b":
            return (rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def models():
    """Per case: (JAX config, port config, JAX params as numpy)."""
    out = {}
    for case in CASES:
        jcfg, tcfg = _configs(case)
        out[case] = (jcfg, tcfg, _jax_params(jcfg))
    return out


def _close(got, want, what, tol=TOL):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, f"{what}: max|port - jax| / max|jax| = {err:.3e}"


def _names(t):
    return [".".join(map(str, k)) for k in tree.leaf_paths(t)]


# ---------------------------------------------------------------------------
# the tree and the parameter count
# ---------------------------------------------------------------------------

def test_period_tree_is_stacked_over_units(models):
    """jamba's period: l0..l7 over 2 units, attention at l4, moe on the odd
    layers, the Mamba mixer elsewhere; the port's own init has JAX's leaves,
    shapes and dtypes."""
    jcfg, tcfg, p = models["jamba-period"]
    assert (TB.unit_size(tcfg), TB.num_units(tcfg)) == (8, 2)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    blocks = own["blocks"]
    assert sorted(blocks) == [f"l{i}" for i in range(8)]
    assert [tcfg.layer_kind(i) for i in range(8)] == \
        ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    for i in range(8):
        sub = blocks[f"l{i}"]
        kind = tcfg.layer_kind(i)
        assert ("attn" in sub) == (kind == "attn") and \
            ("ssm" in sub) == (kind == "ssm")
        assert ("moe" in sub) == (i % 2 == 1) and ("mlp" in sub) == \
            (i % 2 == 0)
        assert all(t.shape[0] == 2 for t in tree.leaves(sub))
    assert _names(own) == _names(bridge.params_from_jax(p, "cpu"))
    for name, t, a in zip(_names(own), tree.leaves(own), jax.tree.leaves(p),
                          strict=True):
        assert (tuple(t.shape), t.dtype) == (a.shape, torch.float32), name


def test_unit_count_must_divide_layers(models):
    _, tcfg, _ = models["jamba-period"]
    with pytest.raises(ValueError, match="whole units"):
        TB.num_units(tcfg.replace(n_layers=12))


@pytest.mark.parametrize("arch", BUILT)
def test_param_count_matches_jax(arch):
    """All and active parameters of the published config, counted on the
    meta device, equal the JAX package's (experts anywhere in the tree)."""
    got = (TM.param_count(TC.get(arch)),
           TM.param_count(TC.get(arch), active_only=True))
    assert got == (JM.param_count(JC.get(arch)),
                   JM.param_count(JC.get(arch), active_only=True))
    if arch in PUBLISHED:
        assert got == PUBLISHED[arch]


def test_bf16_period_tree_crosses_the_bridge():
    """jamba's period in bf16: every leaf bit for bit and in its own dtype
    (the ssm's dt_bias / A_log / Dskip and the router fp32)."""
    jcfg, _ = _configs("jamba-period")
    jp = jax.tree.map(np.asarray, JM.init_params(
        jcfg.replace(dtype="bfloat16"), jax.random.PRNGKey(1)))
    tp = bridge.params_from_jax(jp, "cpu")
    fp32 = {"dt_bias", "A_log", "Dskip", "router"}
    for name, t, a in zip(_names(tp), tree.leaves(tp), jax.tree.leaves(jp),
                          strict=True):
        want = torch.float32 if name.split(".")[-1] in fp32 else \
            torch.bfloat16
        assert t.dtype == want, name
        np.testing.assert_array_equal(bridge.to_numpy(t).view(np.uint8),
                                      a.view(np.uint8), err_msg=name)
    assert sorted(tp["blocks"]) == [f"l{i}" for i in range(8)]


# ---------------------------------------------------------------------------
# forward, prefill + decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(models, case):
    jcfg, tcfg, p = models[case]
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    jl, ja = jax.jit(JM.forward, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, p), jcfg, JRuntime(remat=False),
        {"tokens": jnp.asarray(toks)})
    tl, ta = TM.forward(bridge.params_from_jax(p, "cpu"), tcfg, DEFAULT,
                        {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "logits")
    if case == "falcon":
        assert float(ta) == float(ja) == 0.0
    else:
        assert float(ta) > 0
        _close(ta, ja, "aux")


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(models, case):
    jcfg, tcfg, p = models[case]
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_jax(p, "cpu")
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    max_seq = PROMPT + STEPS + 8
    jrt = JRuntime(remat=False)
    jl, jc = jax.jit(JM.prefill, static_argnums=(1, 2))(
        jp, jcfg, jrt, {"tokens": jnp.asarray(toks)},
        JM.init_cache(jcfg, BATCH, max_seq))
    tc = TM.init_cache(tcfg, BATCH, max_seq)
    assert _names(tc) == [".".join(map(str, (k.key for k in path)))
                          for path, _ in
                          jax.tree_util.tree_flatten_with_path(jc)[0]]
    tl, tc = TM.prefill(tp, tcfg, DEFAULT, {"tokens": torch.from_numpy(toks)},
                        tc)
    jdec = jax.jit(JM.decode_step, static_argnums=(1, 2))
    for s in range(STEPS + 1):
        _close(tl, jl, f"logits, step {s}")
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), S.greedy(tl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if s == STEPS:
            break
        jl, jc = jdec(jp, jcfg, jrt, jt, jc, jnp.int32(PROMPT + s))
        tl, tc = TM.decode_step(tp, tcfg, DEFAULT, tt, tc, PROMPT + s)
    for name, t, a in zip(_names(tc), tree.leaves(tc), jax.tree.leaves(jc),
                          strict=True):
        _close(t, a, f"cache {name}")


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_forward(models, case):
    """prefill(S) then decode(1) equal forward(S + 1)'s last two rows, with
    the dense oracle (no capacity drops), on the port alone."""
    _, tcfg, p = models[case]
    tp = bridge.params_from_jax(p, "cpu")
    rt = Runtime(remat=False, moe_impl="dense")
    B, Sq = 2, 10
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, tcfg.vocab, (B, Sq + 1)).astype(np.int32))
    full, _ = TM.forward(tp, tcfg, rt, {"tokens": toks})
    cache = TM.init_cache(tcfg, B, Sq + 4)
    pre, cache = TM.prefill(tp, tcfg, rt, {"tokens": toks[:, :Sq]}, cache)
    np.testing.assert_allclose(pre.numpy(), full[:, Sq - 1].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    dec, _ = TM.decode_step(tp, tcfg, rt, toks[:, Sq], cache, Sq)
    np.testing.assert_allclose(dec.numpy(), full[:, Sq].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_cached_passes_take_no_router_loss(models, monkeypatch):
    """A cached prefill or decode of the period computes no router loss;
    the forward sums one a moe layer (8 of 16)."""
    _, tcfg, p = models["jamba-period"]
    tp = bridge.params_from_jax(p, "cpu")
    real, calls = TMoE.load_balance_loss, []

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(TMoE, "load_balance_loss", counted)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, tcfg.vocab, (BATCH, PROMPT)).astype(np.int32))
    cache = TM.init_cache(tcfg, BATCH, PROMPT + 4)
    TM.prefill(tp, tcfg, DEFAULT, {"tokens": toks}, cache)
    logits, _ = TM.decode_step(tp, tcfg, DEFAULT, toks[:, 0], cache, PROMPT)
    assert calls == [] and torch.isfinite(logits).all()
    _, aux = TM.forward(tp, tcfg, DEFAULT, {"tokens": toks})
    assert len(calls) == 8 and float(aux) > 0


# ---------------------------------------------------------------------------
# the training loss and its gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grads(models):
    """Per case: JAX's (loss, metrics) and gradients of ``loss_fn`` (remat
    on), and the port's, on one batch."""
    out = {}
    for case, (jcfg, tcfg, p) in models.items():
        batch = np.random.RandomState(4).randint(
            0, jcfg.vocab, size=(2, 13)).astype(np.int32)
        (jl, jm), jg = jax.jit(
            jax.value_and_grad(JM.loss_fn, has_aux=True),
            static_argnums=(1, 2))(jax.tree.map(jnp.asarray, p), jcfg,
                                   JRuntime(remat=True),
                                   {"tokens": jnp.asarray(batch)})
        leaves, spec = tree.flatten(bridge.params_from_jax(p, "cpu"))
        ps = [t.requires_grad_() for t in leaves]
        tl, tm = TM.loss_fn(tree.unflatten(spec, ps), tcfg,
                            Runtime(remat=True),
                            {"tokens": torch.from_numpy(batch)})
        tg = torch.autograd.grad(tl, ps)
        out[case] = (jl, jm, jg, tl, tm, tree.unflatten(spec, list(tg)))
    return out


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_jax(grads, case):
    jl, jm, _, tl, tm, _ = grads[case]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=TOL, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_matches_jax(grads, case):
    """The Mamba mixer's leaves (fp32 dt_bias, A_log, Dskip among them),
    attention, the router and experts, the norms' scales, embeddings."""
    _, _, jg, _, _, tg = grads[case]
    names = _names(tg)
    assert any(n.endswith("A_log") for n in names)
    for name, g, w in zip(names, tree.leaves(tg), jax.tree.leaves(jg),
                          strict=True):
        _close(g, w, name)
        assert float(g.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [FALCON, JAMBA])
def test_serve_on_the_cpu(arch):
    cfg = TC.get_smoke(arch)
    before = (RN.rmsnorm.launches, FA.flash_attention.launches)
    res = S.serve(cfg, requests=3, batch=2, prompt=6, tokens=4, seed=0,
                  device="cpu")
    toks = res["tokens"]
    assert toks.shape == (3, 4) and toks.dtype == torch.int32
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    # on the CPU the plain versions run: no kernel launch is counted
    assert res["launches"] == {"rmsnorm": 0, "flash_attention": 0,
                               "rmsnorm_bwd": 0}
    assert (RN.rmsnorm.launches, FA.flash_attention.launches) == before
    again = S.serve(cfg, requests=3, batch=2, prompt=6, tokens=4, seed=0,
                    device="cpu")
    assert torch.equal(toks, again["tokens"])


@pytest.mark.parametrize("arch", [FALCON, JAMBA])
def test_train_arch_on_the_cpu(arch, capsys):
    assert TRAIN.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                       "--batch", "4", "--seq", "16", "--micro", "2"]) == 0
    out = capsys.readouterr().out
    assert f"[arch] {arch}" in out
    assert "loss" in out and "nan" not in out


@pytest.mark.parametrize("arch", [FALCON, JAMBA])
def test_serve_frees_its_model_without_the_collector(arch, monkeypatch):
    """``serve()``'s weights die when it returns, with the garbage
    collector off: no reference cycle (a ``tree`` walk's closure) holds
    them until its next full pass, which would keep a 52 GB model on the
    card beside the next one."""
    import gc
    import weakref
    real, refs = TM.init_params, []

    def kept(*a, **kw):
        p = real(*a, **kw)
        refs.extend(weakref.ref(t) for t in tree.leaves(p))
        return p

    monkeypatch.setattr(TM, "init_params", kept)
    gc.collect()
    gc.disable()
    try:
        S.serve(TC.get_smoke(arch), requests=2, batch=2, prompt=6, tokens=3,
                seed=0, device="cpu")
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert refs and alive == 0, f"{alive} of {len(refs)} leaves alive"
