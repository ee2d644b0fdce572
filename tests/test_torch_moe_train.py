"""The port's moe training step and entry points against the JAX package,
on the CPU: deepseek-moe-16b's and arctic-480b's smoke configs through the
port's ``bind_train`` and ``repro.distributed.steps.make_train_step`` (two
microbatches, remat on): the loss, the ce and the summed router loss, every
gradient leaf (router, experts, shared experts, the dense residual MLP, the
norms' scales), one SGD step's parameters; then ``serve()`` and
``launch/train.py --arch deepseek-moe-16b`` on the CPU.

JAX's ``init_params`` crosses into the port through
``bridge.params_from_jax`` (norm scales made random in numpy); the token
batch comes from a numpy seed. fp32; JAX at ``highest`` matmul precision
(``tests/conftest.py``). Both route through the sort dispatch at the
config's capacity factor and compute the same math in other orders: within
2e-5 of each leaf's scale (``tests/test_kernels.py::_tol``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.configs.base import InputShape as JShape
from repro.distributed import sharding as JSH
from repro.distributed import steps as JST
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.models.runtime import Runtime as JRuntime
from repro.optim import optimizers as JO
from repro_torch import bridge, tree
from repro_torch.configs.base import InputShape
from repro_torch.distributed import steps as TST
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as S
from repro_torch.launch import train as TRAIN
from repro_torch.models.runtime import Runtime
from repro_torch.optim import optimizers as TO

TOL = 2e-5
ARCHS = ["deepseek-moe-16b", "arctic-480b"]
T_BATCH, T_SEQ, MICRO, SGD_LR = 4, 16, 2, 0.1


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


def _jax_step(jcfg, opt):
    policy = JSH.ShardingPolicy.for_mesh(make_host_mesh())
    step, n = JST.make_train_step(jcfg, JRuntime(remat=True), opt,
                                  JShape("t", T_SEQ, T_BATCH, "train"),
                                  policy, num_microbatches=MICRO)
    assert n == MICRO
    return jax.jit(step)


@pytest.fixture(scope="module")
def steps(models):
    """Per arch: JAX's step gradients (an optimizer that returns the
    gradients it is given) and metrics, and the port's, on one batch."""
    out = {}
    ident = JO.Optimizer(lambda p: {}, lambda p, s, g: (g, s), "grads")
    for arch, (jcfg, tcfg, p) in models.items():
        batch = np.random.RandomState(3).randint(
            0, jcfg.vocab, size=(T_BATCH, T_SEQ + 1)).astype(np.int32)
        jg, _, jm = _jax_step(jcfg, ident)(jax.tree.map(jnp.asarray, p), {},
                                            {"tokens": jnp.asarray(batch)})
        bound = TST.bind_train(tcfg, Runtime(remat=True), TO.sgd(SGD_LR),
                               InputShape("t", T_SEQ, T_BATCH, "train"),
                               num_microbatches=MICRO)
        tg, tm = bound["grads"](bridge.params_from_jax(p, "cpu"),
                                {"tokens": torch.from_numpy(batch)})
        out[arch] = (jg, jm, tg, tm, bound, batch)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_aux_match_jax(steps, arch):
    _, jm, _, tm, _, _ = steps[arch]
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL)
    assert float(tm["aux"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches_jax(steps, arch):
    """The router, the experts, the shared experts (deepseek), the dense
    residual MLP (arctic), the norms' scales, attention and embeddings."""
    jg, _, tg, _, _, _ = steps[arch]
    names = [".".join(k) for k in _paths(tg)]
    assert any("router" in n for n in names) and \
        any("experts" in n for n in names)
    for name, g, w in zip(names, tree.leaves(tg), jax.tree.leaves(jg),
                          strict=True):
        _close(g, w, name)
        assert float(g.abs().max()) > 0, name


def _paths(t, path=()):
    if isinstance(t, dict):
        out = []
        for k in sorted(t):
            out += _paths(t[k], path + (k,))
        return out
    return [path]


def test_sgd_step_matches_jax(models, steps):
    """One ``bind_train`` step (SGD) against the JAX step: every
    parameter within 2e-5 of its scale."""
    jcfg, tcfg, p = models["deepseek-moe-16b"]
    _, _, _, _, bound, batch = steps["deepseek-moe-16b"]
    opt = JO.sgd(SGD_LR)
    jp = jax.tree.map(jnp.asarray, p)
    jnew, _, jm = _jax_step(jcfg, opt)(jp, opt.init(jp),
                                       {"tokens": jnp.asarray(batch)})
    tp = bridge.params_from_jax(p, "cpu")
    tnew, _, tm = bound["step"](tp, TO.sgd(SGD_LR).init(tp),
                                {"tokens": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=TOL)
    for name, g, w in zip(_paths(tnew), tree.leaves(tnew),
                          jax.tree.leaves(jnew), strict=True):
        _close(g, w, ".".join(name))


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------

def test_serve_moe_on_the_cpu():
    cfg = TC.get_smoke("deepseek-moe-16b")
    before = (RN.rmsnorm.launches, RN.rmsnorm_bwd.launches,
              FA.flash_attention.launches)
    res = S.serve(cfg, requests=3, batch=2, prompt=6, tokens=4, seed=0,
                  device="cpu")
    assert res["tokens"].shape == (3, 4)
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()
    assert res["launches"] == {"rmsnorm": 0, "flash_attention": 0,
                               "rmsnorm_bwd": 0}
    assert (RN.rmsnorm.launches, RN.rmsnorm_bwd.launches,
            FA.flash_attention.launches) == before


def test_train_main_moe_on_the_cpu(capsys):
    assert TRAIN.main(["--arch", "deepseek-moe-16b", "--steps", "2",
                       "--batch", "4", "--seq", "8", "--micro", "2",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[arch] deepseek-moe-16b (smoke)" in out and "loss" in out
    assert "'rmsnorm_bwd': 0" in out
