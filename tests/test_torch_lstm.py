"""The port's LSTM slice against the JAX package, on the CPU.

Every input is made with numpy from a seed and handed to both packages; JAX
runs at ``highest`` matmul precision (``tests/conftest.py``). Each test states
its tolerance. The CUDA kernel itself runs only on the card
(``chip_smoke.py``); here the dispatch sends CPU tensors to its plain version.
"""
from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lstm as JLSTM
from repro.optim import rmsprop as jrmsprop
from repro_torch import bridge, tree
from repro_torch import device as D
from repro_torch.kernels import lstm_cell as K
from repro_torch.kernels import ops, ref
from repro_torch.models import lstm as TLSTM
from repro_torch.optim import rmsprop

ROOT = pathlib.Path(__file__).resolve().parents[1]

# tests/test_kernels.py::_tol — fp32 2e-5; bf16 2e-2 (8 mantissa bits)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SWEEP = [(1, 7, 5), (8, 96, 50), (16, 128, 128), (5, 33, 200)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These shapes are tiny: one intra-op thread is as fast, and it leaves
    the other cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell_inputs(B, Din, H, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, Din).astype(np.float32),
            rng.randn(B, H).astype(np.float32),
            rng.randn(B, H).astype(np.float32),
            (rng.randn(Din + H, 4 * H) * 0.1).astype(np.float32),
            (rng.randn(4 * H) * 0.1).astype(np.float32)]


# ---------------------------------------------------------------------------
# (a) the kernel's plain version against the JAX oracle and Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Din,H", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_cell_plain_matches_jax(B, Din, H, dtype):
    arrs = _cell_inputs(B, Din, H, seed=B * 1000 + Din)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    j_in = [jnp.asarray(a).astype(jd) for a in arrs]
    # both packages see the same (rounded) values: round once, in JAX
    t_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(td)
            for a in j_in]
    h_t, c_t = ref.lstm_cell(*t_in)
    assert h_t.dtype == td and c_t.dtype == td
    tol = TOL[dtype]
    for name, (h_j, c_j) in {
            "ref": jref.lstm_cell(*j_in),
            "pallas": jops.lstm_cell(*j_in, interpret=True)}.items():
        np.testing.assert_allclose(h_t.float().numpy(),
                                   np.asarray(h_j, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)
        np.testing.assert_allclose(c_t.float().numpy(),
                                   np.asarray(c_j, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


def test_ops_dispatch_cpu_goes_to_plain_version():
    args = [torch.from_numpy(a) for a in _cell_inputs(3, 4, 5, seed=1)]
    before = K.lstm_cell.launches
    for got, want in zip(ops.lstm_cell(*args), ref.lstm_cell(*args)):
        assert torch.equal(got, want)
    assert K.lstm_cell.launches == before


# (i) the CUDA wrapper refuses what the kernel does not take, before any
# build or launch
@pytest.mark.parametrize("bad,why", [("cpu", "not a CUDA device"),
                                     ("dtype", "bias is torch.float64"),
                                     ("shape", "kernel has shape"),
                                     ("strided", "x is not contiguous"),
                                     ("float64", "not supported")])
def test_cuda_wrapper_raises(bad, why):
    args = [torch.from_numpy(a) for a in _cell_inputs(2, 3, 4, seed=2)]
    if bad == "dtype":
        args[4] = args[4].double()
    elif bad == "shape":
        args[3] = args[3][:-1]
    elif bad == "strided":
        args[0] = torch.from_numpy(np.ones((3, 2), np.float32)).t()
    elif bad == "float64":
        args = [a.double() for a in args]
    before = K.lstm_cell.launches
    with pytest.raises(ValueError, match=why):
        K.lstm_cell(*args)
    assert K.lstm_cell.launches == before


# ---------------------------------------------------------------------------
# (b) lstm_loss and its gradient, params carried across from JAX
# ---------------------------------------------------------------------------

def _loss_case(d_model, vocab, B, T, seed):
    import repro.configs as C
    cfg = C.get("paper-lstm").replace(d_model=d_model, vocab=vocab)
    jparams = JLSTM.init_lstm_model(jax.random.PRNGKey(seed), cfg, vocab)
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(B, T))
    x = np.eye(vocab, dtype=np.float32)[ids]
    y = rng.randint(0, vocab, size=(B,)).astype(np.int32)
    return jparams, {"x": x, "y": y}


@pytest.mark.parametrize("d_model,vocab,B,T", [(16, 64, 4, 20),
                                               (50, 95, 8, 40)],
                         ids=["smoke", "paper"])
def test_lstm_loss_and_grads_match_jax(d_model, vocab, B, T):
    jparams, batch = _loss_case(d_model, vocab, B, T, seed=d_model)
    jl, jg = jax.value_and_grad(JLSTM.lstm_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    leaves, spec = tree.flatten(tparams)
    leaves = [p.requires_grad_(True) for p in leaves]
    tl = TLSTM.lstm_loss(tree.unflatten(spec, leaves),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    tg = torch.autograd.grad(tl, leaves)
    tol = 2e-5
    np.testing.assert_allclose(tl.item(), float(jl), rtol=tol, atol=tol)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)


def test_init_lstm_model_layout_matches_jax():
    from repro_torch.configs.paper_lstm import CONFIG
    cfg = CONFIG.replace(vocab=95)
    tp = TLSTM.init_lstm_model(torch.Generator().manual_seed(0), cfg, 95,
                               "cpu")
    jp, _ = _loss_case(50, 95, 1, 1, seed=0)
    assert [tuple(t.shape) for t in tree.leaves(tp)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    for lp in tp["layers"]:
        H = lp["kernel"].shape[1] // 4
        assert torch.equal(lp["bias"][H:2 * H], torch.ones(H))
        # scale * truncated normal on [-2, 2]
        scale = (2.0 / (lp["kernel"].shape[0] - H + 4 * H)) ** 0.5
        assert lp["kernel"].abs().max().item() <= 2 * scale + 1e-6
    again = TLSTM.init_lstm_model(torch.Generator().manual_seed(0), cfg, 95,
                                  "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(tp),
                                                 tree.leaves(again)))


def test_configs_match_jax():
    from repro.configs import paper_lstm as jcfg
    from repro_torch.configs import paper_lstm as tcfg
    fields = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "norm", "dtype")
    for t, j in ((tcfg.CONFIG, jcfg.CONFIG), (tcfg.smoke(), jcfg.smoke())):
        assert [getattr(t, f) for f in fields] == \
            [getattr(j, f) for f in fields]
    assert tcfg.PAPER_PARAMS == tcfg.TrainParams()
    assert vars(tcfg.PAPER_PARAMS) == vars(jcfg.PAPER_PARAMS)
    assert tcfg.PAPER_PARAMS.batches_per_epoch == 16
    with pytest.raises(ValueError):
        tcfg.TrainParams(batch_size=100)


# ---------------------------------------------------------------------------
# (c) one RMSprop apply from identical grads
# ---------------------------------------------------------------------------

def test_rmsprop_apply_matches_jax():
    jparams, _ = _loss_case(50, 95, 1, 1, seed=3)
    rng = np.random.RandomState(3)
    grads = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 10.0 ** rng.randint(-8, 0))
        .astype(np.float32), jparams)
    jopt = jrmsprop(0.1)
    js0 = jopt.init(jparams)
    jp1, js1 = jopt.update(jparams, js0, jax.tree.map(jnp.asarray, grads))
    jp2, js2 = jopt.update(jp1, js1, jax.tree.map(jnp.asarray, grads))

    opt = rmsprop(0.1)
    tparams = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    ts0 = opt.init(tparams)
    state_np = jax.tree.map(np.asarray, js0)
    carried = bridge.opt_state_from_jax(state_np, "cpu")
    for a, b in zip(tree.leaves(ts0), tree.leaves(carried)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    tg = bridge.params_from_jax(grads, "cpu")
    tp1, ts1 = opt.update(tparams, ts0, tg)
    tp2, ts2 = opt.update(tp1, ts1, tg)
    tol = 1e-6
    for t_tree, j_tree in ((tp1, jp1), (ts1["ms"], js1["ms"]),
                           (tp2, jp2), (ts2["ms"], js2["ms"])):
        for a, b in zip(tree.leaves(bridge.to_numpy(t_tree)),
                        jax.tree.leaves(j_tree), strict=True):
            np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)
    assert ts2["step"].dtype == torch.int32 and int(ts2["step"]) == 2
    assert int(js2["step"]) == 2


# ---------------------------------------------------------------------------
# trees and the bridge
# ---------------------------------------------------------------------------

def test_tree_order_matches_jax_tree():
    t = {"b": [1, (2, 3)], "a": {"z": 4, "y": [5]}, "c": 6}
    assert tree.leaves(t) == jax.tree.leaves(t)
    leaves, spec = tree.flatten(t)
    rebuilt = tree.unflatten(spec, [x * 10 for x in leaves])
    assert rebuilt == jax.tree.map(lambda x: x * 10, t)
    assert list(rebuilt) == list(t)            # key order kept
    assert tree.map(lambda a, b: a + b, t, t) == jax.tree.map(
        lambda a, b: a + b, t, t)
    with pytest.raises(ValueError):
        tree.map(lambda a, b: a, t, {"b": [1, (2, 3)]})
    with pytest.raises(ValueError):
        tree.unflatten(spec, leaves + [7])


def test_bridge_round_trip():
    jparams, _ = _loss_case(16, 64, 1, 1, seed=4)
    np_tree = jax.tree.map(np.asarray, jparams)
    back = bridge.to_numpy(bridge.params_from_jax(np_tree, "cpu"))
    for a, b in zip(jax.tree.leaves(np_tree), tree.leaves(back), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        bridge.opt_state_from_jax({"ms": np_tree, "step": np.float32(0)},
                                  "cpu")


# ---------------------------------------------------------------------------
# (g) import hygiene, (h) no silent CPU fallback
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


# run in a fresh interpreter: any import of jax or of the reference package
# raises, then every module of repro_torch is imported (walked, not listed)
# and the gateway's CLI runs as ``python -m``
_IMPORT_ALL = """
import importlib, pkgutil, runpy, sys
class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("the port imported " + name)
sys.meta_path.insert(0, _Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
print("modules", len(names), " ".join(sorted(names)))
sys.argv = ["gateway", "--help"]
runpy.run_module("repro_torch.core.gateway", run_name="__main__")
"""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert not hits, hits
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    first = out.stdout.splitlines()[0].split()
    names = set(first[2:])
    assert int(first[1]) == len(names) == len(files) - 1 - sum(
        p.name == "__init__.py" and p.parent.name == "repro_torch"
        for p in files)
    for mod in ("checkpoint.serialize", "core.applier", "core.browser",
                "core.elastic", "core.gateway", "core.simulator",
                "core.traces", "core.wsframing", "analysis.base",
                "analysis.runtime"):
        assert f"repro_torch.{mod}" in names
    assert "--real-apply" in out.stdout and "--device" in out.stdout


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.core.mapreduce import TrainingProblem
    from repro_torch.data.text import synthetic_corpus
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainingProblem.paper_problem(corpus=synthetic_corpus(2000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--paper", "--versions", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "stablelm-1.6b", "--steps", "1"])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen1.5-110b", "--requests", "1"])
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    from repro_torch.core import gateway
    for mode in ("--serve", "--volunteer"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gateway.main([mode, "--real-apply", "--port", "1"])
    assert D.resolve("cpu") == torch.device("cpu")
