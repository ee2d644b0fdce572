"""Tensor-parallel compute over the mesh's ``model`` axis and
``seq_parallel`` training (``distributed/spmd.py``'s plans, Megatron's
entry and exit, the vocab-parallel loss) against the JAX package, on the
CPU.

- Four gloo ranks (``tests/torch_mesh_ranks.py``, job kind ``"tp"``) on
  ``(data=2, model=2)`` and ``(data=1, model=4)`` run the smoke configs of
  stablelm-1.6b, deepseek-moe-16b (capacity 0.5), falcon-mamba-7b,
  whisper-base and qwen1.5-110b, and internvl2-1b's at vocab 511 (which 4
  does not divide: its embed and unembed compute replicated). On (1, 4)
  qwen's two kv heads take the head_dim fallback, so its attention gathers
  them whole and slices each rank's.
- Each trains one step (fp32, remat, two microbatches) with SGD and with
  AdamW, with and without ``seq_parallel``. The ranks' shards are put
  together by their specs and held against the JAX ``make_train_step``
  (the step ``bind_train`` binds) on the same bridged weights: the loss
  within 2e-5 relative, SGD's parameters and AdamW's m and v (linear and
  quadratic in the gradient, so every gradient is held, the norm scales'
  under ``seq_parallel`` included) within 2e-5 of the leaf's max. The
  JAX reference is its step's gradient (an identity optimizer), the SGD
  and AdamW updates applied here in numpy: the reference's seq_parallel
  only constrains its layout, not its arithmetic.
- deepseek's dispatches drop what the JAX router drops.
- Each serves (prefill and three greedy decode steps): the tokens equal
  the JAX binders', the logits within 2e-5 of max |logit|.
- The route was taken: the widths each module computed with (the query
  heads the attention kernels saw, FFN columns, experts, d_inner, the
  vocab) are the ``model`` shard's, and every case's collectives, counted
  by ``spmd.COLLECTIVES``, are what ``spmd.step_collectives`` predicts.
- A ``seq_parallel`` step at a sequence ``model`` does not divide raises
  ``ValueError`` before any collective.
- On the production mesh (16, 16), on meta tensors: which leaves each of
  the ten configs computes as its ``model`` shard, and finite predicted
  collectives for a training and a serving step.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.base import InputShape as JShape
from repro.distributed import sharding as JSH
from repro.distributed import steps as JST
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models.runtime import Runtime as JRuntime
from repro.optim import optimizers as JO
import repro_torch.configs as C
from repro_torch import bridge, tree
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd as SP
from repro_torch.distributed import steps as TST
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.models.runtime import Runtime
from repro_torch.optim import optimizers as TO

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS_PY = ROOT / "tests" / "torch_mesh_ranks.py"
TOL = 2e-5
RANK_TIMEOUT_S = 60        # every collective of a rank
JOB_TIMEOUT_S = 300        # the four ranks of a mesh, end to end
ADAM_B1, ADAM_B2 = 0.9, 0.95      # optim/optimizers.py's adamw defaults


def _ranks_module():
    spec = importlib.util.spec_from_file_location("torch_mesh_ranks_tp",
                                                  RANKS_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _ranks_module()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(case):
    arch, _, vocab = case.partition("@")
    cfg = JC.get_smoke(arch)
    if vocab:
        cfg = cfg.replace(vocab=int(vocab))
    if cfg.moe.num_experts:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=R.MOE_CAPACITY))
    return cfg


def _jax_params(jcfg, seed=0):
    """JAX's params as numpy, biases and norm scales drawn at random (JAX
    initialises them to 0 and 1)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                     jax.random.PRNGKey(seed)))

    def perturb(path, a):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "bias", "conv_b", "dt_bias"):
            return (rng.randn(*a.shape) * 0.02).astype(a.dtype)
        if name == "scale":
            return (1 + rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _entries(cfg, batch, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for k, s in batch.items():
        if s.dtype == torch.int32:
            out[k] = rng.randint(0, cfg.vocab, size=s.shape).astype(np.int32)
        else:
            out[k] = rng.randn(*s.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Per case: the configs, JAX's params (numpy), a training batch and a
    prompt batch; written for the ranks to ``in_<case>.npz``."""
    d = tmp_path_factory.mktemp("tp")
    out = {"dir": d}
    for case in R.TP_CASES:
        jcfg, tcfg = _jcfg(case), R.config(case)
        np_params = _jax_params(jcfg)
        leaves = [t.numpy() for t in tree.leaves(
            bridge.params_from_jax(np_params, "cpu"))]
        batch = _entries(tcfg, TM.train_batch_spec(tcfg, R.train_shape()), 3)
        prompt = _entries(tcfg, TST.prefill_batch_spec(
            tcfg, InputShape("p", R.PROMPT, R.SERVE_BATCH, "prefill")), 5)
        np.savez(d / f"in_{case}.npz", n=len(leaves),
                 **{f"p{i}": a for i, a in enumerate(leaves)},
                 **{f"b_{k}": v for k, v in batch.items()},
                 **{f"q_{k}": v for k, v in prompt.items()})
        out[case] = dict(jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                         leaves=leaves, batch=batch, prompt=prompt)
    return out


def _launch(root, shape):
    d = root / f"run_{shape[0]}x{shape[1]}"
    d.mkdir()
    for case in R.TP_CASES:
        os.link(root / f"in_{case}.npz", d / f"in_{case}.npz")
    job = d / "job.json"
    job.write_text(json.dumps({"dir": str(d), "mesh": list(shape),
                               "kind": "tp", "store": str(d / "store"),
                               "timeout_s": RANK_TIMEOUT_S}))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(int(np.prod(shape))):
        with open(d / f"log_r{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(RANKS_PY), str(job), str(r)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    return procs, d


@pytest.fixture(scope="module")
def rank_jobs(inputs):
    """Both mesh shapes' ranks, started as soon as the inputs exist, so
    they run while this process computes the references; any still running
    at the module's end are killed."""
    jobs = {shape: _launch(inputs["dir"], shape) for shape in R.TP_MESHES}
    yield jobs
    for procs, _ in jobs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=R.TP_MESHES,
                ids=[f"{d}x{m}" for d, m in R.TP_MESHES])
def mesh_run(request, rank_jobs):
    shape = request.param
    procs, d = rank_jobs[shape]
    deadline = time.monotonic() + JOB_TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    bad = [(r, p.returncode, (d / f"log_r{r}.txt").read_text()[-3000:])
           for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    out = {f.stem: dict(np.load(f)) for f in d.glob("*_r*.npz")}
    return dict(shape=shape, n=len(procs), out=out)


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------

_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _jnp(entries):
    return {k: jnp.asarray(v) for k, v in entries.items()}


def _jax_grads(inputs, case):
    """The JAX step's gradients (``make_train_step`` with an identity
    optimizer, remat, two microbatches) on the port's tree, and its
    metrics."""
    def run():
        c = inputs[case]
        ident = JO.Optimizer(lambda p: {}, lambda p, s, g: (g, s), "grads")
        policy = JSH.ShardingPolicy.for_mesh(j_host_mesh())
        step, n = JST.make_train_step(c["jcfg"], JRuntime(remat=True), ident,
                                      JShape("t", R.SEQ, R.BATCH, "train"),
                                      policy, num_microbatches=R.MICRO)
        assert n == R.MICRO
        g, _, m = jax.jit(lambda p, b: step(p, {}, b))(
            jax.tree.map(jnp.asarray, c["np_params"]), _jnp(c["batch"]))
        return (bridge.params_from_jax(jax.tree.map(np.asarray, g), "cpu"),
                {k: float(v) for k, v in m.items()})
    return _memo(("grads", case), run)


def _jax_serve(inputs, case):
    def run():
        c = inputs[case]
        jcfg, rt, mesh = c["jcfg"], JRuntime(remat=False), j_host_mesh()
        pre = JST.bind_prefill(mesh, jcfg, rt, JShape("p", R.PROMPT,
                                                      R.SERVE_BATCH,
                                                      "prefill"))
        dec = JST.bind_decode(mesh, jcfg, rt, JShape("d", R.MAX_SEQ,
                                                     R.SERVE_BATCH, "decode"))
        p = jax.tree.map(jnp.asarray, c["np_params"])
        cache = JM.init_cache(jcfg, R.SERVE_BATCH, R.MAX_SEQ,
                              dtype=jnp.float32)
        logits, cache = pre["step"](p, _jnp(c["prompt"]), cache)
        out_l, out_t = [], []
        for t in range(R.DECODE + 1):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            out_l.append(np.asarray(logits))
            out_t.append(np.asarray(tok))
            if t == R.DECODE:
                break
            logits, cache = dec["step"](p, cache, tok,
                                        jnp.int32(R.PROMPT + t))
        return np.stack(out_l), np.stack(out_t)
    return _memo(("serve", case), run)


def _jax_drops(inputs):
    """Each microbatch's dropped assignments a moe layer in the JAX
    package: its router's choices on the microbatch's tokens, counted
    against the capacity."""
    def run():
        c = inputs["deepseek-moe-16b"]
        log, orig = [], JMOE.apply_moe_sort

        def recording(p, x, cfg, capacity_factor, **kw):
            m = cfg.moe
            cap = max(int(m.top_k * x.shape[0] * capacity_factor /
                          m.num_experts), 1)
            _, idx = jax.lax.top_k(JMOE.router_probs(p, x), m.top_k)
            counts = jnp.zeros(m.num_experts, jnp.int32).at[
                idx.reshape(-1)].add(1)
            jax.debug.callback(lambda d: log.append(int(d)),
                               jnp.sum(jnp.maximum(counts - cap, 0)))
            return orig(p, x, cfg, capacity_factor, **kw)

        JMOE.apply_moe_sort = recording
        try:
            p = jax.tree.map(jnp.asarray, c["np_params"])
            rows = R.BATCH // R.MICRO
            per_micro = []
            for i in range(R.MICRO):
                mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                      for k, v in c["batch"].items()}
                log.clear()
                jax.block_until_ready(JM.loss_fn(
                    p, c["jcfg"], JRuntime(remat=False), mb))
                jax.effects_barrier()
                per_micro.append(list(log))
        finally:
            JMOE.apply_moe_sort = orig
        return per_micro
    return _memo("drops", run)


# ---------------------------------------------------------------------------
# assembling the ranks' shards
# ---------------------------------------------------------------------------

def _policy(shape, **kw):
    return SH.ShardingPolicy(("data", "model"), tuple(shape), **kw)


def _coord(rank, shape):
    return {"data": rank // shape[1], "model": rank % shape[1]}


def _spec_slice(a, spec, shape, coord):
    sizes = {"data": shape[0], "model": shape[1]}
    for d, entry in enumerate(spec):
        for ax in SH.axes_of(entry):
            a = np.split(a, sizes[ax], axis=d)[coord[ax]]
    return a


def _assembled(run, stem, prefix, cfg):
    """Each leaf put together from every rank's shard by its spec; ranks
    that hold the same slice must hold it bit for bit."""
    pshape = TM.init_params(cfg, None, "meta")
    specs = tree.leaves(SH.param_specs(pshape, _policy(run["shape"])),
                        is_leaf=SH.is_spec)
    leaves = []
    for i, (leaf, spec) in enumerate(zip(tree.leaves(pshape), specs)):
        full = np.full(tuple(leaf.shape), np.nan, np.float32)
        for r in range(run["n"]):
            shard = run["out"][f"{stem}_r{r}"][f"{prefix}{i}"]
            view = _spec_slice(full, spec, run["shape"],
                               _coord(r, run["shape"]))
            assert view.shape == shard.shape, (i, spec, view.shape)
            held = ~np.isnan(view)
            np.testing.assert_array_equal(view[held], shard[held])
            view[...] = shard
        assert not np.isnan(full).any(), (i, spec)
        leaves.append(full)
    return tree.unflatten(pshape, leaves)


def _close(got, want, tol, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if scale is None else scale,
                1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def _close_tree(got, want, tol, what):
    """Each leaf within ``tol`` of its max |want|. A key bias's gradient
    is rounding noise where no RoPE follows (a query adds q.bk to every
    score alike), so it is held to its ``wk``'s scale, as
    ``tests/test_torch_distributed.py`` holds it."""
    paths = tree.leaf_paths(want)
    leaves = dict(zip(paths, tree.leaves(want)))
    for path, g, w in zip(paths, tree.leaves(got), tree.leaves(want),
                          strict=True):
        scale = None
        if path[-1] == "bk":
            scale = float(np.abs(leaves[path[:-1] + ("wk",)]).max())
        _close(g, w, tol, f"{what} {'.'.join(map(str, path))}", scale)


def _np(tr):
    return tree.map(lambda t: t.detach().numpy().astype(np.float64), tr)


# ---------------------------------------------------------------------------
# the steps against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [False, True], ids=["tp", "seq_parallel"])
@pytest.mark.parametrize("case", R.TP_CASES)
def test_train_step_matches_jax(mesh_run, inputs, case, sp):
    """Loss, SGD's parameters and AdamW's m and v (the gradient's first
    and second moments) against the JAX step's gradients."""
    c = inputs[case]
    tag = "sp" if sp else "tp"
    g, jm = _jax_grads(inputs, case)
    g = _np(g)
    p0 = _np(R.params_of(c["tcfg"], c["leaves"]))
    for opt_name in ("sgd", "adamw"):
        stem = f"{tag}_{case}_{opt_name}"
        for r in range(mesh_run["n"]):
            got = mesh_run["out"][f"{stem}_r{r}"]
            for k in ("loss", "ce", "aux"):
                np.testing.assert_allclose(float(got[f"m_{k}"]), jm[k],
                                           rtol=TOL, atol=1e-7)
    lr = R.LR["sgd"]
    sgd = _assembled(mesh_run, f"{tag}_{case}_sgd", "p", c["tcfg"])
    _close_tree(sgd, tree.map(lambda p, d: p - lr * d, p0, g), TOL,
                f"{tag} sgd params vs JAX")
    m = _assembled(mesh_run, f"{tag}_{case}_adamw", "sm_", c["tcfg"])
    v = _assembled(mesh_run, f"{tag}_{case}_adamw", "sv_", c["tcfg"])
    _close_tree(m, tree.map(lambda d: (1 - ADAM_B1) * d, g), TOL,
                f"{tag} adamw m vs JAX")
    _close_tree(v, tree.map(lambda d: (1 - ADAM_B2) * d * d, g), TOL,
                f"{tag} adamw v vs JAX")


def test_moe_drops_match_the_reference(mesh_run, inputs):
    """Each microbatch's dispatches (its forward, then the recompute in
    reverse) drop what the JAX router drops on the microbatch's tokens,
    with and without seq_parallel."""
    want = _jax_drops(inputs)
    n_layers = inputs["deepseek-moe-16b"]["tcfg"].n_layers
    expect = []
    for drops in want:
        assert len(drops) == n_layers and all(d > 0 for d in drops), want
        expect += drops + drops[::-1]
    for tag in ("tp", "sp"):
        for r in range(mesh_run["n"]):
            got = mesh_run["out"][f"{tag}_deepseek-moe-16b_sgd_r{r}"]
            assert list(got["drops"]) == expect, (tag, r)


@pytest.mark.parametrize("case", R.TP_CASES)
def test_serve_matches_jax(mesh_run, inputs, case):
    jl, jt = _jax_serve(inputs, case)
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"serve_{case}_r{r}"]
        np.testing.assert_array_equal(got["tokens"], jt)
        for i in range(len(jl)):
            _close(got["logits"][i], jl[i], TOL, f"{case} rank {r} step {i}")


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _want_widths(cfg, m):
    """The widths each module computes with at ``model`` = m: a dim the
    spec splits over ``model`` divided by m, the others whole."""
    out = {}
    if cfg.n_heads:
        out["attention"] = cfg.n_heads // m if cfg.n_heads % m == 0 \
            else cfg.n_heads
    if cfg.d_ff and cfg.family not in ("ssm",):
        out["mlp"] = cfg.d_ff // m
    if cfg.moe.num_experts:
        out["experts"] = cfg.moe.num_experts // m
        out["shared"] = cfg.moe.num_shared * cfg.moe.d_expert // m
        del out["mlp"]
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = cfg.d_inner() // m
        out.pop("attention", None)
    v = cfg.padded_vocab
    out["embed"] = out["logits"] = v // m if v % m == 0 else v
    return out


@pytest.mark.parametrize("case", R.TP_CASES)
def test_modules_compute_their_model_shard(mesh_run, inputs, case):
    """Each module computed with its ``model`` shard's width (the vocab
    511 case's embed and unembed whole): on (1, 4) every sublayer kind,
    attention, mlp, experts, ssm and embed/unembed, at a quarter."""
    cfg = inputs[case]["tcfg"]
    m = mesh_run["shape"][1]
    want = _want_widths(cfg, m)
    for stem in (f"tp_{case}_sgd", f"sp_{case}_adamw", f"serve_{case}"):
        got = mesh_run["out"][f"{stem}_r0"]
        seen = {k[2:]: set(got[k].tolist()) for k in got if
                k.startswith("w_")}
        for what, width in want.items():
            assert seen[what] == {width}, (stem, what, seen[what], width)
    if m == 4:
        whole = _want_widths(cfg, 1)
        replicated = {k for k in want if want[k] == whole[k]}
        assert replicated == ({"embed", "logits"} if "@" in case
                              else set()), replicated


@pytest.mark.parametrize("case", R.TP_CASES)
def test_collectives_match_the_prediction(mesh_run, inputs, case):
    """Every case's collectives, training (remat, with and without
    seq_parallel), prefill and decode, are ``spmd.step_collectives``'s;
    the ``model`` all-reduces are there."""
    cfg, shape = inputs[case]["tcfg"], mesh_run["shape"]
    pshape = TM.init_params(cfg, None, "meta")
    for tag, sp in (("tp", False), ("sp", True)):
        pol = _policy(shape, seq_parallel=sp)
        want = SP.step_collectives(pshape, SH.param_specs(pshape, pol), pol,
                                   passes=2, backward=True, micro=R.MICRO)
        for opt_name in ("sgd", "adamw"):
            got = mesh_run["out"][f"{tag}_{case}_{opt_name}_r0"]
            assert {k: int(got[f"c_{k}"]) for k in SP.KINDS} == want, \
                (tag, opt_name)
        assert want["all_reduce"] > R.MICRO * 2
        assert want["all_reduce_max"] == (
            0 if "@" in case else R.MICRO)
    pol = _policy(shape)
    cache = TM.init_cache(cfg, R.SERVE_BATCH, R.MAX_SEQ, device="meta")
    served = mesh_run["out"][f"serve_{case}_r0"]
    for i, decode in ((0, False), (1, True)):
        want = SP.step_collectives(pshape, SH.param_specs(pshape, pol), pol,
                                   gather_logits=True, cache_shape=cache,
                                   decode=decode)
        assert {k: int(served[f"c{i}_{k}"]) for k in SP.KINDS} == want, i
        assert want["all_reduce"] > 0


def test_seq_parallel_refuses_an_undivided_sequence(mesh_run):
    """On the ranks, before any collective; and on the production mesh
    for the tokens and for an encdec encoder's frames."""
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"refusal_r{r}"]
        assert "does not split" in str(got["raised"])
        assert int(got["calls"]) == 0
    mesh = TMESH.make_production_mesh()
    pol = SH.ShardingPolicy.for_mesh(mesh, seq_parallel=True)
    for arch, seq, what in (("stablelm-1.6b", 4_104, "a sequence"),
                            ("whisper-base", 4_096, "an encoder")):
        with pytest.raises(ValueError, match="seq_parallel"):
            TST.bind_train(mesh, C.get(arch), Runtime(), TO.sgd(0.1),
                           InputShape("t", seq, 256, "train"), policy=pol)
    # a divided one binds (and then refuses the abstract mesh)
    with pytest.raises(ValueError, match="abstract mesh"):
        TST.bind_train(mesh, C.get("stablelm-1.6b"), Runtime(), TO.sgd(0.1),
                       InputShape("t", 4_096, 256, "train"), policy=pol)


class _OneProcess:
    """A layout's gradient taps as identities: the forward of each
    ``model`` rank's split, run in one process."""

    @staticmethod
    def enter(x):
        return x

    @staticmethod
    def grad_scale(x, s):
        return x


@pytest.mark.parametrize("impl", ["sort", "dense"])
def test_moe_expert_shards_sum_to_the_whole(impl):
    """The routed experts' partial sums over 4 ranks (``spmd.plan``'s
    splits) add up to the whole layer's output, for the sort dispatch (at
    a capacity where experts drop assignments) and the dense oracle; the
    load-balance loss is the same on every rank."""
    from repro_torch.models import moe as MOE
    cfg = R.config("deepseek-moe-16b")
    g = torch.Generator().manual_seed(0)
    p = MOE.init_moe(g, cfg, torch.float32, "cpu")
    x = torch.randn((64, cfg.d_model), generator=g)
    run = {"sort": lambda p_, s: MOE.apply_moe_sort(
        p_, x, cfg, cfg.moe.capacity_factor, split=s),
        "dense": lambda p_, s: MOE.apply_moe_dense(p_, x, cfg, split=s)}[impl]
    whole, aux = run(p, None)
    m = 4
    specs = {"router": SH.P(None, None),
             **{f"experts.{n}": SH.P("model", None, None)
                for n in p["experts"]}}
    leaves = {k: a for k, a in SP.module_leaves(p).items() if k in specs}
    shapes = {k: tuple(a.shape) for k, a in leaves.items()}
    total = torch.zeros_like(whole)
    for r in range(m):
        split, modes = SP.plan("moe", shapes, specs, m, r)
        assert modes == {k: "whole" if k == "router" else "local"
                         for k in specs}
        local = {k: SP.local_slice(a, specs[k], {"model": m}, {"model": r})
                 for k, a in leaves.items()}
        part, aux_r = run({"router": local["router"],
                           "experts": {n: local[f"experts.{n}"]
                                       for n in p["experts"]}},
                          dataclasses.replace(split, layout=_OneProcess()))
        total += part
        assert torch.equal(aux_r, aux)
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6 * float(whole.abs().max()))


# ---------------------------------------------------------------------------
# the production mesh's decisions (meta tensors, no collective)
# ---------------------------------------------------------------------------

ARCHS = [a for a in C.ARCH_IDS if C.get(a).family != "rnn"]

# per config at (16, 16): the modules that compute their model shard, and
# the leaves gathered whole over model although their module splits
SPLIT = {
    "arctic-480b": ({"mlp", "moe", "embed", "unembed"}, set()),
    "deepseek-moe-16b": ({"attn", "moe", "embed", "unembed"}, set()),
    "falcon-mamba-7b": ({"ssm", "embed", "unembed"}, {"ssm.in_proj"}),
    "internvl2-1b": ({"mlp"}, set()),
    "jamba-v0.1-52b": ({"attn", "mlp", "moe", "ssm", "embed", "unembed"},
                       {"attn.wk", "attn.wv", "ssm.in_proj"}),
    "minitron-4b": ({"mlp", "embed", "unembed"}, set()),
    "nemotron-4-340b": ({"attn", "mlp", "embed", "unembed"},
                        {"attn.wk", "attn.wv"}),
    "qwen1.5-110b": ({"attn", "mlp", "embed", "unembed"},
                     {"attn.wk", "attn.wv", "attn.bk", "attn.bv"}),
    "stablelm-1.6b": ({"attn", "mlp", "embed", "unembed"}, set()),
    "whisper-base": ({"mlp"}, set()),
}


def test_production_mesh_decisions():
    """Which modules each config computes as its ``model`` shard on (16,
    16) (``spmd.plan_table``): qwen's ``wq`` splits while its 8 kv heads
    are gathered whole and sliced (4 query heads a rank over one kv head);
    narrow-head configs (arctic's 56, internvl2's 14, minitron's 24 and
    whisper's 8 heads) take the head_dim fallback and attend replicated;
    odd vocabs (internvl2's, whisper's) compute their logits replicated."""
    assert sorted(ARCHS) == sorted(SPLIT)
    policy = SH.ShardingPolicy.for_mesh(TMESH.make_production_mesh())
    for arch in ARCHS:
        cfg = C.get(arch)
        pshape = TM.init_params(cfg, None, "meta")
        table = SP.plan_table(pshape, SH.param_specs(pshape, policy), policy)
        split = {mk for (_, mk), (s, _) in table.items() if s is not None}
        whole = {f"{mk}.{leaf}" for (_, mk), (s, modes) in table.items()
                 if s is not None for leaf, mode in modes.items()
                 if mode == "summed"}
        assert (split, whole) == SPLIT[arch], (arch, split, whole)
        qwen = arch == "qwen1.5-110b"
        if qwen:
            s, modes = table[("blocks.l0", "attn")]
            assert (s.n, s.kv, s.kv_whole) == (4, (0, 1), True)
            assert modes["wq"] == "local" and modes["wk"] == "summed"


@pytest.mark.parametrize("arch", ARCHS)
def test_production_mesh_predicts_finite_collectives(arch):
    """A training step (remat, seq_parallel off and on) and a serving
    prefill and decode at decode_32k's cache, predicted from the specs on
    (16, 16)."""
    cfg = C.get(arch)
    policy = SH.ShardingPolicy.for_mesh(TMESH.make_production_mesh())
    pshape = TM.init_params(cfg, None, "meta")
    pspecs = SH.param_specs(pshape, policy)
    for sp in (False, True):
        pol = dataclasses.replace(policy, seq_parallel=sp)
        got = SP.step_collectives(pshape, pspecs, pol, passes=2,
                                  backward=True, micro=4)
        assert all(math.isfinite(v) and v >= 0 for v in got.values())
        assert got["all_reduce"] > 0
    cache = TM.init_cache(cfg, 128, 32_768, device="meta")
    for decode in (False, True):
        got = SP.step_collectives(pshape, pspecs, policy, cache_shape=cache,
                                  gather_logits=True, decode=decode)
        assert all(math.isfinite(v) and v >= 0 for v in got.values())
        assert got["all_gather"] > 0
