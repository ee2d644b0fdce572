"""The port's Mamba-1 mixer (``repro_torch/models/ssm.py``) against the JAX
package's ``repro/models/ssm.py``, on the CPU: the init tree, the chunk
scan against ``lax.associative_scan``, ``apply_ssm`` at chunks 4, 8 and 16
(lengths the chunk divides and not), from a zero and from a given state,
``apply_ssm_step``, the gradients of every leaf and of the input, the
prefill state continuing into decode and the chunked scan against the step
recurrence (the port's counterparts of ``tests/test_models.py``'s), and a
bf16 falcon-mamba tree crossing the bridge with its fp32 leaves kept.

Layer 0's params of JAX's falcon-mamba-7b smoke model cross through
``bridge.params_from_jax`` (conv_b, Dskip made random in numpy so they
count); inputs come from a numpy seed. fp32; JAX at ``highest`` matmul
precision (``tests/conftest.py``): within 2e-5 of scale
(``tests/test_kernels.py::_tol``).
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
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.runtime import Runtime as JRuntime
from repro_torch import bridge, tree
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

TOL = 2e-5
RECURRENCE_TOL = 2e-4        # tests/test_models.py's for the same checks
ARCH = "falcon-mamba-7b"
FP32_LEAVES = ("dt_bias", "A_log", "Dskip")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    """(JAX config, port config, layer 0's ssm params as numpy)."""
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    p = jax.tree.map(np.asarray, JS.init_ssm(jax.random.PRNGKey(0), jcfg,
                                             jnp.float32))
    rng = np.random.RandomState(0)
    p["conv_b"] = (rng.randn(*p["conv_b"].shape) * 0.1).astype(np.float32)
    p["Dskip"] = (1 + rng.randn(*p["Dskip"].shape) * 0.1).astype(np.float32)
    return jcfg, tcfg, p


def _close(got, want, what, tol=TOL):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, f"{what}: max|port - jax| / max|jax| = {err:.3e}"


def _chunked(cfg, chunk):
    """cfg with the scan's chunk length set to ``chunk``."""
    return cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))


def _x(jcfg, B, S, seed):
    return (np.random.RandomState(seed).randn(B, S, jcfg.d_model) * 0.5) \
        .astype(np.float32)


def _state(jcfg, B, seed):
    rng = np.random.RandomState(seed)
    return {"conv": (rng.randn(B, jcfg.ssm.d_conv - 1, jcfg.d_inner()) * 0.5)
            .astype(np.float32),
            "h": (rng.randn(B, jcfg.d_inner(), jcfg.ssm.d_state) * 0.5)
            .astype(np.float32)}


def _both(p, state=None):
    jp = jax.tree.map(jnp.asarray, p)
    tp = bridge.params_from_jax(p, "cpu")
    if state is None:
        return jp, tp
    return jp, tp, jax.tree.map(jnp.asarray, state), \
        bridge.params_from_jax(state, "cpu")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_tree_matches_jax(layer, dtype):
    """Every leaf's shape and dtype (dt_bias, A_log and Dskip fp32 whatever
    the model's dtype), A_log within an ulp, softplus(dt_bias) in [1e-3, 1e-1]."""
    jcfg, tcfg, _ = layer
    jp = JS.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    tp = TS.init_ssm(torch.Generator().manual_seed(0), tcfg,
                     getattr(torch, dtype), "cpu")
    meta = TS.init_ssm(None, tcfg, getattr(torch, dtype), "meta")
    assert sorted(tp) == sorted(jp) == sorted(meta)
    for k in jp:
        want = (tuple(jp[k].shape), jnp.dtype(jp[k].dtype).name)
        for t in (tp[k], meta[k]):
            assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == want, k
        if k in FP32_LEAVES:
            assert tp[k].dtype == torch.float32, k
    # log(1..N) a row, to an ulp of either library's log
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-7, atol=0)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 1e-1 * 1.001


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 2, 3, 7, 16])
def test_scan_chunk_matches_associative_scan(L):
    """The odd/even recursion in JAX's order of combines, at even and odd
    lengths (the recursion's two branches)."""
    rng = np.random.RandomState(L)
    a = rng.uniform(0.5, 1.0, (2, L, 3, 4)).astype(np.float32)
    b = rng.randn(2, L, 3, 4).astype(np.float32)
    h0 = rng.randn(2, 3, 4).astype(np.float32)
    jh, jl = JS._scan_chunk(jnp.asarray(h0), jnp.asarray(a), jnp.asarray(b))
    th, tl = TS._scan_chunk(*(torch.from_numpy(t) for t in (h0, a, b)))
    _close(th, jh, "h_all", 1e-6)
    _close(tl, jl, "h_last", 1e-6)


# ---------------------------------------------------------------------------
# apply_ssm / apply_ssm_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [13, 16])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_apply_ssm_matches_jax(layer, chunk, S):
    """Without a state, and from a given state into the new one (conv
    window and fp32 h); 13 positions are no whole number of chunks."""
    jcfg, tcfg, p = layer
    jcfg, tcfg = _chunked(jcfg, chunk), _chunked(tcfg, chunk)
    x = _x(jcfg, 2, S, 1)
    jp, tp, js, ts = _both(p, _state(jcfg, 2, 2))
    jo, _ = JS.apply_ssm(jp, jnp.asarray(x), jcfg, JRuntime())
    to, none = TS.apply_ssm(tp, torch.from_numpy(x), tcfg)
    assert none is None
    _close(to, jo, "out")
    jo, jst = JS.apply_ssm(jp, jnp.asarray(x), jcfg, JRuntime(), state=js)
    to, tst = TS.apply_ssm(tp, torch.from_numpy(x), tcfg, state=ts)
    _close(to, jo, "out from a state")
    _close(tst["conv"], jst["conv"], "conv state")
    _close(tst["h"], jst["h"], "h")
    assert tst["h"].dtype == torch.float32


def test_apply_ssm_step_matches_jax(layer):
    jcfg, tcfg, p = layer
    x = _x(jcfg, 3, 1, 3)
    jp, tp, js, ts = _both(p, _state(jcfg, 3, 4))
    jo, jst = JS.apply_ssm_step(jp, jnp.asarray(x), jcfg, js)
    to, tst = TS.apply_ssm_step(tp, torch.from_numpy(x), tcfg, ts)
    _close(to, jo, "out")
    _close(tst["conv"], jst["conv"], "conv state")
    _close(tst["h"], jst["h"], "h")


def test_apply_ssm_grads_match_jax(layer):
    """Every leaf's gradient and the input's, of sum(out * w), against
    ``jax.grad``, through two chunks and a padded tail."""
    jcfg, tcfg, p = layer
    jcfg, tcfg = _chunked(jcfg, 8), _chunked(tcfg, 8)
    x = _x(jcfg, 2, 11, 5)
    w = np.random.RandomState(6).randn(2, 11, jcfg.d_model).astype(np.float32)

    def jloss(p, x):
        out, _ = JS.apply_ssm(p, x, jcfg, JRuntime())
        return jnp.sum(out * w)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    leaves, spec = tree.flatten(bridge.params_from_jax(p, "cpu"))
    ps = [t.requires_grad_() for t in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = TS.apply_ssm(tree.unflatten(spec, ps), tx, tcfg)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                                ps + [tx])
    names = [".".join(k) for k in tree.leaf_paths(p)]
    for name, g, want in zip(names, grads[:-1], jax.tree.leaves(jg),
                             strict=True):
        _close(g, want, name)
    _close(grads[-1], jgx, "dx")


def test_prefill_state_continues_decode(layer):
    """prefill(S) into a state, then one step, equals the full sequence's
    last row (``tests/test_models.py::test_ssm_prefill_state_continues_decode``)."""
    _, tcfg, p = layer
    tcfg = _chunked(tcfg, 4)
    tp = bridge.params_from_jax(p, "cpu")
    S = 12
    x = torch.from_numpy(_x(tcfg, 1, S + 1, 7))
    full, _ = TS.apply_ssm(tp, x, tcfg)
    st = TS.init_ssm_state(tcfg, 1, torch.float32, "cpu")
    _, st = TS.apply_ssm(tp, x[:, :S], tcfg, state=st)
    dec, _ = TS.apply_ssm_step(tp, x[:, S:], tcfg, st)
    np.testing.assert_allclose(dec.numpy(), full[:, S:].numpy(),
                               rtol=RECURRENCE_TOL, atol=RECURRENCE_TOL)


def test_chunked_scan_matches_step_recurrence(layer):
    """``tests/test_models.py::test_ssm_chunked_scan_matches_step_recurrence``
    on the port: 23 positions in chunks of 8 against 23 decode steps."""
    _, tcfg, p = layer
    tcfg = _chunked(tcfg, 8)
    tp = bridge.params_from_jax(p, "cpu")
    x = torch.from_numpy(_x(tcfg, 2, 23, 8))
    chunked, _ = TS.apply_ssm(tp, x, tcfg)
    st = TS.init_ssm_state(tcfg, 2, torch.float32, "cpu")
    steps = []
    for t in range(23):
        y, st = TS.apply_ssm_step(tp, x[:, t:t + 1], tcfg, st)
        steps.append(y)
    np.testing.assert_allclose(chunked.numpy(), torch.cat(steps, 1).numpy(),
                               rtol=RECURRENCE_TOL, atol=RECURRENCE_TOL)


def test_init_ssm_state_dtypes(layer):
    _, tcfg, _ = layer
    st = TS.init_ssm_state(tcfg, 3, torch.bfloat16, "cpu")
    assert st["conv"].shape == (3, tcfg.ssm.d_conv - 1, tcfg.d_inner())
    assert st["conv"].dtype == torch.bfloat16
    assert st["h"].shape == (3, tcfg.d_inner(), tcfg.ssm.d_state)
    assert st["h"].dtype == torch.float32
    assert not st["conv"].any() and not st["h"].any()


# ---------------------------------------------------------------------------
# a bf16 tree across the bridge
# ---------------------------------------------------------------------------

def test_bf16_falcon_tree_crosses_the_bridge():
    """JAX's falcon-mamba smoke tree in bf16 (the published dtype): every
    leaf bit for bit, its dtype kept (dt_bias, A_log and Dskip fp32 inside
    the bf16 tree), and the port's own init gives the same leaves and
    dtypes."""
    jcfg = JC.get_smoke(ARCH).replace(dtype="bfloat16")
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jp, "cpu")
    own = TM.init_params(TC.get_smoke(ARCH).replace(dtype="bfloat16"),
                         torch.Generator().manual_seed(0), "cpu")
    names = [".".join(k) for k in tree.leaf_paths(tp)]
    assert names == [".".join(k) for k in tree.leaf_paths(own)]
    assert sorted(tp["blocks"]) == ["l0"]
    for name, t, o, a in zip(names, tree.leaves(tp), tree.leaves(own),
                             jax.tree.leaves(jp), strict=True):
        want = torch.float32 if name.split(".")[-1] in FP32_LEAVES \
            else torch.bfloat16
        assert t.dtype == o.dtype == want, name
        assert tuple(t.shape) == tuple(o.shape) == a.shape, name
        np.testing.assert_array_equal(bridge.to_numpy(t).view(np.uint8),
                                      a.view(np.uint8), err_msg=name)
