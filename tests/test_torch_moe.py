"""The port's moe layer (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``), on the CPU.

JAX's ``init_moe`` of a smoke config crosses into the port through
``bridge.params_from_jax``, and the same tokens (numpy, from a seed) go
through both. fp32 throughout; JAX runs at ``highest`` matmul precision
(``tests/conftest.py``). The two compute the same math in other orders, so
the outputs agree within 2e-5 of their scale (``tests/test_kernels.py::
_tol``), while the routing is compared exactly: the chosen experts (idx)
and the sort dispatch's keep mask must be equal. Where a token's k-th and
(k+1)-th router probabilities lie closer than 1e-6 (a true near-tie, which
either package may break either way), the test prints the margin; none of
these inputs has one.

Cases: both moe configs (deepseek-moe-16b's shared experts, arctic-480b's
dense residual beside the experts) and a smoke config with
deepseek-moe-16b's published routing (64 experts, top-6), whose four-token
decode step gets one slot an expert (C = 1), the serving decode's
situation; the sort dispatch at capacity factor 1.25 (tokens drop), 8.0
(none drop) and at C = 1; the sort path at ample capacity against the dense
oracle (``tests/test_models.py::test_moe_sort_matches_dense_when_capacity
_ample`` on the port). ``apply_moe`` with its shared experts, the
gradients and the whole models are in ``tests/test_torch_moe_model.py``.
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
from repro.models import moe as JMoE
from repro_torch import bridge, tree
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.runtime import Runtime

TOL = 2e-5
NEAR_TIE = 1e-6
ARCHS = ["deepseek-moe-16b", "arctic-480b"]
# beside the two smoke configs: deepseek-moe-16b's smoke widths with its
# published router (64 experts, top-6, 2 shared)
CASES = ARCHS + ["deepseek-routing"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(case, dtype="float32"):
    if case == "deepseek-routing":
        j, t = (C.get_smoke("deepseek-moe-16b") for C in (JC, TC))
        moe = dataclasses.replace(j.moe, num_experts=64, top_k=6,
                                  num_shared=2)
        return (j.replace(moe=moe, dtype=dtype),
                t.replace(moe=dataclasses.replace(t.moe, num_experts=64,
                                                  top_k=6, num_shared=2),
                          dtype=dtype))
    return (JC.get_smoke(case).replace(dtype=dtype),
            TC.get_smoke(case).replace(dtype=dtype))


@pytest.fixture(scope="module")
def layers():
    """Per case: (JAX config, port config, JAX params as numpy, the port's
    params bridged)."""
    out = {}
    for i, case in enumerate(CASES):
        jcfg, tcfg = _configs(case)
        p = jax.tree.map(np.asarray, JMoE.init_moe(jax.random.PRNGKey(i),
                                                   jcfg, jnp.float32))
        out[case] = (jcfg, tcfg, p, bridge.params_from_jax(p, "cpu"))
    return out


def _x(T, D, seed=1):
    return np.random.RandomState(seed).randn(T, D).astype(np.float32)


def _jp(p):
    return jax.tree.map(jnp.asarray, p)


def _close(got, want, what, tol=TOL):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(np.abs(w).max(), 1e-30)
    err = np.abs(g - w).max() / scale
    assert err <= tol, f"{what}: max|port - jax| / max|jax| = {err:.3e}"


def _margin(probs, k):
    """The least gap between a token's k-th and (k+1)-th probability."""
    s = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    return float(np.min(s[:, k - 1] - s[:, k])) if s.shape[1] > k else 1.0


def _jax_dispatch(idx, C):
    """The keep mask of ``repro/models/moe.py::apply_moe_sort`` (its lines,
    outside the function, which does not return it)."""
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - \
        first.astype(jnp.int32)
    return np.asarray(order), np.asarray(pos_in_e < C)


# ---------------------------------------------------------------------------
# init and parameter counts
# ---------------------------------------------------------------------------

def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    return (tuple(t.shape), str(t.dtype).split(".")[-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_tree_matches_jax(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = JMoE.init_moe(jax.random.PRNGKey(0), jcfg, jdt)
    tp = TMoE.init_moe(torch.Generator().manual_seed(0), tcfg, tdt, "cpu")
    assert _shapes(tp) == _shapes(jp)
    assert tp["router"].dtype == torch.float32          # fp32 in bf16 too
    if arch == "deepseek-moe-16b":
        assert "shared" in tp and tp["shared"]["wi"].shape[1] == \
            tcfg.moe.num_shared * tcfg.moe.d_expert
    else:
        assert "shared" not in tp


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_tree_on_meta_matches_jax(arch):
    """The published configs' whole trees, shapes and dtypes, without
    allocating: the port on the meta device, JAX by ``eval_shape``."""
    jshapes = jax.eval_shape(lambda k: JM.init_params(JC.get(arch), k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    tp = TM.init_params(TC.get(arch), None, "meta")
    assert _shapes(tp) == _shapes(jshapes)
    assert tp["blocks"]["l0"]["moe"]["router"].dtype == torch.float32
    assert ("mlp" in tp["blocks"]["l0"]) == (arch == "arctic-480b")


@pytest.mark.parametrize("arch,total,active", [
    ("deepseek-moe-16b", 16_879_568_896, 2_830_747_648),
    ("arctic-480b", 476_850_275_328, 15_584_314_368)])
def test_param_count_matches_jax(arch, total, active):
    cfg = TC.get(arch)
    assert TM.param_count(cfg) == total == JM.param_count(JC.get(arch))
    assert TM.param_count(cfg, active_only=True) == active == \
        JM.param_count(JC.get(arch), active_only=True)
    if arch == "deepseek-moe-16b":
        # the 2-layer cut chip_smoke.py trains
        cut = cfg.replace(n_layers=2)
        assert (TM.param_count(cut),
                TM.param_count(cut, active_only=True)) == \
            (1_595_156_480, 591_669_248)


def test_runtime_capacity_factor(layers):
    """The runtime dispatches by sort at the config's capacity factor, as
    serving and training run it."""
    assert Runtime().moe_impl == "sort"
    _, tcfg, _, tp = layers["arctic-480b"]
    x = torch.from_numpy(_x(64, tcfg.d_model))
    out, aux = TMoE.apply_moe(tp, x[None], tcfg, Runtime())
    want, want_aux = TMoE.apply_moe_sort(tp, x, tcfg,
                                         tcfg.moe.capacity_factor)
    assert torch.equal(out[0], want) and torch.equal(aux, want_aux)
    bare, none = TMoE.apply_moe(tp, x[None], tcfg, Runtime(), with_aux=False)
    assert none is None and torch.equal(bare, out)
    cfg = TC.get("deepseek-moe-16b")
    # the serving decode: 4 tokens, top-6 of 64 -> one slot an expert
    assert TMoE.capacity(cfg, 4, 1.25) == 1
    assert TMoE.capacity(cfg, 4096, 1.25) == 480


# ---------------------------------------------------------------------------
# router, routing, aux loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_router_probs_route_and_aux_match_jax(layers, case):
    jcfg, tcfg, p, tp = layers[case]
    x = _x(64, jcfg.d_model)
    k, E = jcfg.moe.top_k, jcfg.moe.num_experts
    jprobs = JMoE.router_probs(_jp(p), jnp.asarray(x))
    tprobs = TMoE.router_probs(tp, torch.from_numpy(x))
    _close(tprobs, jprobs, "probs")
    print(f"{case}: least k-th / (k+1)-th margin {_margin(jprobs, k):.3e}")
    jgate, jidx = jax.lax.top_k(jprobs, k)
    tgate, tidx = TMoE.route(tprobs, k)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tgate, jgate, "gate")
    _close(TMoE.load_balance_loss(tprobs, tidx, E),
           JMoE.load_balance_loss(jprobs, jidx, E), "aux")


def test_route_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` keeps the lower index first among equal values."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        _, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        _, tidx = TMoE.route(torch.from_numpy(probs), k)
        assert np.array_equal(tidx.numpy(), np.asarray(jidx)), k


# ---------------------------------------------------------------------------
# the dense oracle and the sort dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_apply_moe_dense_matches_jax(layers, case):
    jcfg, tcfg, p, tp = layers[case]
    x = _x(48, jcfg.d_model, seed=2)
    jo, ja = JMoE.apply_moe_dense(_jp(p), jnp.asarray(x), jcfg)
    to, ta = TMoE.apply_moe_dense(tp, torch.from_numpy(x), tcfg)
    _close(to, jo, "out")
    _close(ta, ja, "aux")


# (tokens, capacity factor): drops at 1.25, none at 8.0; four tokens at
# 0.5 give C = 1 at every router, at 1.25 C = 2 at the smoke router (4
# experts, top-2) and C = 1 at the published one (the serving decode)
SORT = [(64, 1.25), (64, 8.0), (4, 0.5), (4, 1.25)]


@pytest.mark.parametrize("T,cf", SORT)
@pytest.mark.parametrize("case", CASES)
def test_apply_moe_sort_matches_jax(layers, case, T, cf):
    jcfg, tcfg, p, tp = layers[case]
    k, E = jcfg.moe.top_k, jcfg.moe.num_experts
    x = _x(T, jcfg.d_model, seed=T)
    C = TMoE.capacity(tcfg, T, cf)
    assert C == max(int(k * T * cf / E), 1)
    jo, ja = JMoE.apply_moe_sort(_jp(p), jnp.asarray(x), jcfg, cf)
    to, ta = TMoE.apply_moe_sort(tp, torch.from_numpy(x), tcfg, cf)
    _close(to, jo, "out")
    _close(ta, ja, "aux")
    # the routing, exactly: idx and the keep mask (sorted order)
    jprobs = JMoE.router_probs(_jp(p), jnp.asarray(x))
    _, jidx = jax.lax.top_k(jprobs, k)
    _, tidx = TMoE.route(TMoE.router_probs(tp, torch.from_numpy(x)), k)
    margin = _margin(jprobs, k)
    if margin < NEAR_TIE:
        print(f"{case} T={T}: a near-tie, margin {margin:.3e}")
    assert np.array_equal(tidx.numpy(), np.asarray(jidx))
    jorder, jkeep = _jax_dispatch(jidx, C)
    order, _, _, keep, _ = TMoE.dispatch(tidx, C)
    assert np.array_equal(order.numpy(), jorder)
    assert np.array_equal(keep.numpy(), jkeep)
    if cf == 8.0:
        assert keep.all()
    if C == 1:
        # one slot an expert: an expert chosen by two tokens drops one
        loads = np.bincount(np.asarray(jidx).ravel(), minlength=E)
        assert int((~keep).sum()) == int(np.maximum(loads - 1, 0).sum())


@pytest.mark.parametrize("case", CASES)
def test_sort_matches_dense_when_capacity_ample(layers, case):
    """``tests/test_models.py``'s sort-vs-oracle check on the port."""
    _, tcfg, _, tp = layers[case]
    x = torch.from_numpy(_x(64, tcfg.d_model, seed=5))
    out_d, aux_d = TMoE.apply_moe_dense(tp, x, tcfg)
    out_s, aux_s = TMoE.apply_moe_sort(tp, x, tcfg, capacity_factor=8.0)
    np.testing.assert_allclose(out_s.numpy(), out_d.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_s), float(aux_d), rtol=1e-5)


def test_capacity_drops_change_outputs(layers):
    _, tcfg, _, tp = layers["arctic-480b"]
    x = torch.from_numpy(_x(64, tcfg.d_model))
    tight, _ = TMoE.apply_moe_sort(tp, x, tcfg, capacity_factor=0.25)
    ample, _ = TMoE.apply_moe_sort(tp, x, tcfg, capacity_factor=8.0)
    assert not torch.allclose(tight, ample)


def test_leaf_paths_are_jax_key_paths(layers):
    """``tree.leaf_paths`` names the leaves in ``tree.leaves`` order with
    the keys ``jax.tree_util`` gives them."""
    _, _, p, tp = layers["deepseek-moe-16b"]
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(p)[0]]
    assert tree.leaf_paths(tp) == want
    assert tree.leaf_paths({"a": [1, (2, 3)], "b": 4}) == [
        ("a", 0), ("a", 1, 0), ("a", 1, 1), ("b",)]
