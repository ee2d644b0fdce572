"""The port's moe transformers (deepseek-moe-16b's and arctic-480b's smoke
configs) against the JAX package, on the CPU: ``apply_moe`` and its
gradients, the model's forward (logits and the summed router loss) and
prefill + greedy decode. The training step and the entry points are in
``tests/test_torch_moe_train.py``.

JAX's ``init_params`` crosses into the port through
``bridge.params_from_jax`` (norm scales made random in numpy, so they
count); tokens come from a numpy seed. fp32; JAX at ``highest`` matmul
precision (``tests/conftest.py``). Both packages route through the sort
dispatch at the config's capacity factor (tokens drop at decode, where a
smoke batch of 2 tokens gets one slot an expert) and compute the same
math in other orders, so the numbers agree within 2e-5 of their scale
(``tests/test_kernels.py::_tol``); the greedy tokens are equal. The port's
own prefill + decode is also held against its forward with the dense
oracle (``tests/test_models.py::test_decode_matches_forward`` on the port,
rtol 2e-4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models.runtime import Runtime as JRuntime
from repro_torch import bridge, tree
from repro_torch.launch import serve as S
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.runtime import DEFAULT, Runtime

TOL = 2e-5
DECODE_TOL = 2e-4
ARCHS = ["deepseek-moe-16b", "arctic-480b"]
PROMPT, BATCH, STEPS = 9, 2, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(jcfg, seed=0):
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(
        seed)))

    def perturb(path, a):
        if path[-1].key == "scale":
            return (1 + rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX config, port config, JAX params as numpy)."""
    return {arch: (JC.get_smoke(arch), TC.get_smoke(arch),
                   _jax_params(JC.get_smoke(arch)))
            for arch in ARCHS}


def _close(got, want, what, tol=TOL):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, f"{what}: max|port - jax| / max|jax| = {err:.3e}"


def _moe_layer(models, arch):
    """Layer 0's moe params of the model, both packages."""
    jcfg, tcfg, p = models[arch]
    mp = jax.tree.map(lambda a: a[0], p["blocks"]["l0"]["moe"])
    return jcfg, tcfg, mp, bridge.params_from_jax(mp, "cpu")


# ---------------------------------------------------------------------------
# apply_moe: the shared experts, the runtime's implementation, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["sort", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(models, arch, impl):
    """``apply_moe`` on [B, S, D], the shared experts added where the config
    has them, through the runtime's implementation and capacity."""
    jcfg, tcfg, mp, tp = _moe_layer(models, arch)
    x = np.random.RandomState(7).randn(2, 7, jcfg.d_model).astype(np.float32)
    jo, ja = JMoE.apply_moe(jax.tree.map(jnp.asarray, mp), jnp.asarray(x),
                            jcfg, JRuntime(moe_impl=impl))
    to, ta = TMoE.apply_moe(tp, torch.from_numpy(x), tcfg,
                            Runtime(moe_impl=impl))
    _close(to, jo, "out")
    _close(ta, ja, "aux")


@pytest.mark.parametrize("impl", ["sort", "dense"])
def test_apply_moe_grads_match_jax(models, impl):
    """Every leaf's gradient (router, experts, shared) and the input's, of
    sum(out * w) + aux, against ``jax.grad``."""
    jcfg, tcfg, mp, _ = _moe_layer(models, "deepseek-moe-16b")
    rng = np.random.RandomState(9)
    x = rng.randn(2, 9, jcfg.d_model).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = JMoE.apply_moe(p, x, jcfg, JRuntime(moe_impl=impl))
        return jnp.sum(out * w) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, mp), jnp.asarray(x))
    leaves, spec = tree.flatten(bridge.params_from_jax(mp, "cpu"))
    ps = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TMoE.apply_moe(tree.unflatten(spec, ps), tx, tcfg,
                              Runtime(moe_impl=impl))
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)) + aux,
                                ps + [tx])
    for i, (g, want) in enumerate(zip(grads[:-1], jax.tree.leaves(jg),
                                      strict=True)):
        _close(g, want, f"leaf {i}")
    _close(grads[-1], jgx, "dx")


# ---------------------------------------------------------------------------
# the model: forward, prefill + decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(models, arch):
    jcfg, tcfg, p = models[arch]
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    jl, ja = jax.jit(JM.forward, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, p), jcfg, JRuntime(remat=False),
        {"tokens": jnp.asarray(toks)})
    tl, ta = TM.forward(bridge.params_from_jax(p, "cpu"), tcfg, DEFAULT,
                        {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "logits")
    assert ta.dtype == torch.float32 and float(ta) > 0
    _close(ta, ja, "aux")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch):
    jcfg, tcfg, p = models[arch]
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_jax(p, "cpu")
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    max_seq = PROMPT + STEPS + 8
    jrt = JRuntime(remat=False)
    jl, jc = jax.jit(JM.prefill, static_argnums=(1, 2))(
        jp, jcfg, jrt, {"tokens": jnp.asarray(toks)},
        JM.init_cache(jcfg, BATCH, max_seq))
    tl, tc = TM.prefill(tp, tcfg, DEFAULT, {"tokens": torch.from_numpy(toks)},
                        TM.init_cache(tcfg, BATCH, max_seq))
    jdec = jax.jit(JM.decode_step, static_argnums=(1, 2))
    for s in range(STEPS + 1):
        _close(tl, jl, f"logits, step {s}")
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), S.greedy(tl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if s == STEPS:
            break
        jl, jc = jdec(jp, jcfg, jrt, jt, jc, jnp.int32(PROMPT + s))
        tl, tc = TM.decode_step(tp, tcfg, DEFAULT, tt, tc, PROMPT + s)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_take_no_router_loss(models, arch, monkeypatch):
    """Serving takes no loss, so a cached prefill or decode computes no
    router loss; the forward still sums one a moe layer."""
    from repro_torch.models import blocks as B
    _, tcfg, p = models[arch]
    tp = bridge.params_from_jax(p, "cpu")
    real, calls = TMoE.load_balance_loss, []

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(TMoE, "load_balance_loss", counted)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, tcfg.vocab, (BATCH, PROMPT)).astype(np.int32))
    cache = TM.init_cache(tcfg, BATCH, PROMPT + 4)
    x = TM._embed(tcfg, tp, toks)
    _, cache, aux = B.scan_units(tp["blocks"], x, tcfg, DEFAULT,
                                 positions=TM._positions(toks), pos=0,
                                 cache=cache)
    assert aux is None
    logits, cache = TM.decode_step(tp, tcfg, DEFAULT, toks[:, 0], cache,
                                   PROMPT)
    assert calls == [] and torch.isfinite(logits).all()
    _, aux = TM.forward(tp, tcfg, DEFAULT, {"tokens": toks})
    assert len(calls) == tcfg.n_layers and float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_dense_forward(models, arch):
    """prefill(S) then decode(1) equal forward(S + 1)'s last two rows, all
    with the dense oracle (no capacity drops), on the port alone."""
    _, tcfg, p = models[arch]
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
