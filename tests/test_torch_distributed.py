"""The port's steps on meshes (``distributed/{sharding,spmd,steps}.py``,
``launch/mesh.py``) against the JAX package, on the CPU.

- One device's host mesh: ``bind_prefill`` / ``bind_decode`` against the
  JAX binders on the same bridged weights (stablelm-1.6b, deepseek-moe-16b,
  falcon-mamba-7b and whisper-base smoke configs): every step's logits
  within 2e-5 of max |logit| (fp32), equal greedy tokens.
- Four gloo ranks (``tests/torch_mesh_ranks.py``, spawned once a mesh
  shape) on ``(data=2, model=2)`` and ``(data=4, model=1)``: one
  ``bind_train`` step of each config with SGD and with AdamW, fp32, remat,
  two microbatches. The ranks' shards are put together by their specs and
  held against the JAX ``bind_train`` on its host mesh and the port's own
  host-mesh step: the loss within 2e-5 relative; with SGD every parameter
  within 2e-5 of its leaf's max; with AdamW the optimizer state (m and v,
  linear and quadratic in the gradient) within 2e-5 of its leaf's max.
  AdamW's first step moves a weight by lr * g / (|g| + eps), which turns a
  last-bit difference of a gradient near eps into a visible step, so its
  parameters are held only through that state, as
  ``tests/test_torch_train_arch.py`` holds its AdamW steps by their losses.
- Each rank's stored shards are the slices their specs define (the
  placement against a slicing of the test's own), ranks that share a slice
  hold it bit for bit, and on (2, 2) every config has leaves sharded over
  ``data`` and over ``model``.
- deepseek-moe-16b runs at capacity factor 0.5, where every microbatch
  drops assignments: the ranks' dispatches drop what the JAX package's
  router drops on each microbatch's global tokens.
- One step accumulates in bf16 (``grad_accum_dtype``): its gradients
  within 2e-2 of max |g| of the JAX step's under the same policy.
- Prefill and decode across the ranks give the host mesh's tokens and
  logits; the collectives a step issues are those ``spmd.step_collectives``
  predicts from the specs (on (2, 2) the modules split over ``model``
  add their entries and exits; ``tests/test_torch_tensor_parallel.py``
  holds that route, and ``seq_parallel``, to the JAX package).
- Under the (4, 1) process group ``make_host_mesh`` is that DeviceMesh, and
  ``launch.serve.serve`` and ``launch.train.run_arch`` run on it: the host
  runs' tokens and losses, and one checkpoint (rank 0's) of the host run's
  parameters, gathered a leaf at a time (no rank holds two whole leaves).
- On the host mesh a step bound with ``donate=False`` leaves the trees it
  was given as they were, and returns what the donating step returns.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
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
from repro_torch import bridge, tree
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd as SP
from repro_torch.distributed import steps as TST
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import serve as TS
from repro_torch.launch import train as TTR
from repro_torch.models import model as TM
from repro_torch.models.runtime import Runtime
from repro_torch.optim import optimizers as TO

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS_PY = ROOT / "tests" / "torch_mesh_ranks.py"
TOL, BF16_TOL = 2e-5, 2e-2
RANK_TIMEOUT_S = 60        # every collective of a rank
JOB_TIMEOUT_S = 300        # the four ranks of a mesh, end to end


def _ranks_module():
    spec = importlib.util.spec_from_file_location("torch_mesh_ranks",
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


def _jcfg(arch):
    cfg = JC.get_smoke(arch)
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


def _entries(cfg, batch, seq, seed):
    """A batch as ``launch.train.sample_batch`` draws it (numpy)."""
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
    """Per arch: the configs, JAX's params (numpy), a training batch and a
    prompt batch; written for the ranks to ``in_<arch>.npz``."""
    d = tmp_path_factory.mktemp("mesh")
    out = {"dir": d}
    for arch in R.ARCHS:
        jcfg, tcfg = _jcfg(arch), R.config(arch)
        np_params = _jax_params(jcfg)
        leaves = [t.numpy() for t in tree.leaves(
            bridge.params_from_jax(np_params, "cpu"))]
        batch = _entries(tcfg, TM.train_batch_spec(tcfg, R.train_shape()),
                         R.SEQ, 3)
        prompt = _entries(tcfg, TST.prefill_batch_spec(
            tcfg, InputShape("p", R.PROMPT, R.SERVE_BATCH, "prefill")),
            R.PROMPT, 5)
        np.savez(d / f"in_{arch}.npz", n=len(leaves),
                 **{f"p{i}": a for i, a in enumerate(leaves)},
                 **{f"b_{k}": v for k, v in batch.items()},
                 **{f"q_{k}": v for k, v in prompt.items()})
        out[arch] = dict(jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                         leaves=leaves, batch=batch, prompt=prompt)
    return out


def _torch(entries):
    return {k: torch.from_numpy(v) for k, v in entries.items()}


def _jnp(entries):
    return {k: jnp.asarray(v) for k, v in entries.items()}


# ---------------------------------------------------------------------------
# the references: the JAX binders and the port's host mesh
# ---------------------------------------------------------------------------

_MEMO = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def _jax_train(inputs, arch, opt_name):
    def run():
        case = inputs[arch]
        opt = JO.make(opt_name, R.LR[opt_name])
        bound = JST.bind_train(j_host_mesh(), case["jcfg"],
                               JRuntime(remat=True), opt,
                               JShape("t", R.SEQ, R.BATCH, "train"),
                               num_microbatches=R.MICRO, donate=False)
        p = jax.tree.map(jnp.asarray, case["np_params"])
        p, s, m = bound["step"](p, opt.init(p), _jnp(case["batch"]))
        return (bridge.params_from_jax(jax.tree.map(np.asarray, p), "cpu"),
                {k: bridge.params_from_jax(jax.tree.map(np.asarray, s[k]),
                                           "cpu") for k in ("m", "v")
                 if k in s}, {k: float(v) for k, v in m.items()})
    return _memo(("jax_train", arch, opt_name), run)


def _host_train(inputs, arch, opt_name):
    def run():
        case = inputs[arch]
        p, s, m, drops, _, _ = R.train_case(
            TMESH.make_host_mesh("cpu"), case["tcfg"],
            R.params_of(case["tcfg"], case["leaves"]), _torch(case["batch"]),
            opt_name)
        return p, s, {k: float(v) for k, v in m.items()}, drops
    return _memo(("host_train", arch, opt_name), run)


def _host_serve(inputs, arch):
    case = inputs[arch]
    return _memo(("host_serve", arch), lambda: R.serve_case(
        TMESH.make_host_mesh("cpu"), case["tcfg"],
        R.params_of(case["tcfg"], case["leaves"]), _torch(case["prompt"])))


def _jax_serve(inputs, arch):
    case = inputs[arch]
    jcfg, rt, mesh = case["jcfg"], JRuntime(remat=False), j_host_mesh()
    pre = JST.bind_prefill(mesh, jcfg, rt, JShape("p", R.PROMPT,
                                                  R.SERVE_BATCH, "prefill"))
    dec = JST.bind_decode(mesh, jcfg, rt, JShape("d", R.MAX_SEQ,
                                                 R.SERVE_BATCH, "decode"))
    p = jax.tree.map(jnp.asarray, case["np_params"])
    cache = JM.init_cache(jcfg, R.SERVE_BATCH, R.MAX_SEQ, dtype=jnp.float32)
    logits, cache = pre["step"](p, _jnp(case["prompt"]), cache)
    out_l, out_t = [], []
    for t in range(R.DECODE + 1):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out_l.append(np.asarray(logits))
        out_t.append(np.asarray(tok))
        if t == R.DECODE:
            break
        logits, cache = dec["step"](p, cache, tok, jnp.int32(R.PROMPT + t))
    return np.stack(out_l), np.stack(out_t)


def _close(got, want, tol, what, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if scale is None else scale,
                1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


@pytest.mark.parametrize("arch", R.ARCHS)
def test_host_mesh_serve_matches_jax(inputs, rank_jobs, arch):
    logits, toks, calls = _host_serve(inputs, arch)
    jl, jt = _jax_serve(inputs, arch)
    assert logits.shape == jl.shape
    for i in range(len(jl)):
        _close(logits[i].numpy(), jl[i], TOL, f"{arch} step {i} logits")
    np.testing.assert_array_equal(toks.numpy(), jt)
    # one device: no collective
    assert all(sum(c.values()) == 0 for c in calls)


# ---------------------------------------------------------------------------
# the gloo ranks
# ---------------------------------------------------------------------------

def _launch(root, shape):
    """Start the four ranks of one mesh shape on the inputs in ``root``,
    each logging to its own file: (processes, run directory)."""
    d = root / f"run_{shape[0]}x{shape[1]}"
    d.mkdir()
    for arch in R.ARCHS:
        os.link(root / f"in_{arch}.npz", d / f"in_{arch}.npz")
    job = d / "job.json"
    job.write_text(json.dumps({"dir": str(d), "mesh": list(shape),
                               "store": str(d / "store"),
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
    """Both mesh shapes' ranks, started together as soon as the inputs
    exist, so they run while this process computes the references; any
    still running at the module's end are killed."""
    jobs = {shape: _launch(inputs["dir"], shape) for shape in R.MESHES}
    yield jobs
    for procs, _ in jobs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", params=R.MESHES,
                ids=[f"{d}x{m}" for d, m in R.MESHES])
def mesh_run(request, rank_jobs):
    """Every case of one mesh shape, run once by four gloo ranks: what each
    rank wrote, by file stem."""
    shape = request.param
    procs, d = rank_jobs[shape]
    deadline = time.monotonic() + JOB_TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    bad = [(r, p.returncode,
            (d / f"log_r{r}.txt").read_text()[-3000:])
           for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    out = {f.stem: dict(np.load(f)) for f in d.glob("*_r*.npz")}
    return dict(shape=shape, n=len(procs), out=out, dir=d)


def _policy(shape):
    return SH.ShardingPolicy(("data", "model"), tuple(shape))


def _coord(rank, shape):
    return {"data": rank // shape[1], "model": rank % shape[1]}


def _spec_slice(a, spec, shape, coord):
    """The slice of ``a`` that ``spec`` gives the rank at ``coord``: each
    dim split by its entry's axes in turn, major axis first."""
    sizes = {"data": shape[0], "model": shape[1]}
    for d, entry in enumerate(spec):
        for ax in SH.axes_of(entry):
            a = np.split(a, sizes[ax], axis=d)[coord[ax]]
    return a


def _assembled(run, stem, prefix, cfg):
    """Each leaf put together from every rank's shard by the leaf's spec;
    ranks that hold the same slice must hold it bit for bit."""
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
        leaves.append(torch.from_numpy(full))
    return tree.unflatten(pshape, leaves)


def _close_tree(got, want, tol, what):
    """Each leaf within ``tol`` of its max |want|. A key bias without RoPE
    has a zero gradient (a query adds q.bk to every score alike), so its
    gradient, and AdamW's state of it, are rounding noise: held to its
    ``wk``'s scale, as ``tests/test_torch_encdec.py`` holds it."""
    paths = tree.leaf_paths(want)
    leaves = dict(zip(paths, tree.leaves(want)))
    for path, g, w in zip(paths, tree.leaves(got), tree.leaves(want),
                          strict=True):
        scale = None
        if path[-1] == "bk":
            scale = float(leaves[path[:-1] + ("wk",)].abs().max())
        _close(g.detach().numpy(), w.detach().numpy(), tol,
               f"{what} {'.'.join(map(str, path))}", scale)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_mesh_train_step_matches_jax(mesh_run, inputs, arch, opt_name):
    stem = f"train_{arch}_{opt_name}"
    cfg = inputs[arch]["tcfg"]
    jp, js, jm = _jax_train(inputs, arch, opt_name)
    hp, hs, hm, _ = _host_train(inputs, arch, opt_name)
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"{stem}_r{r}"]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(got[f"m_{k}"]), jm[k],
                                       rtol=TOL, atol=1e-7)
            np.testing.assert_allclose(float(got[f"m_{k}"]), hm[k],
                                       rtol=TOL, atol=1e-7)
    if opt_name == "sgd":
        params = _assembled(mesh_run, stem, "p", cfg)
        _close_tree(params, jp, TOL, "params vs JAX")
        _close_tree(params, hp, TOL, "params vs host mesh")
    else:
        for slot in ("m", "v"):
            state = _assembled(mesh_run, stem, f"s{slot}_", cfg)
            _close_tree(state, js[slot], TOL, f"adamw {slot} vs JAX")
            _close_tree(state, hs[slot], TOL, f"adamw {slot} vs host mesh")


@pytest.mark.parametrize("arch", R.ARCHS)
def test_mesh_shards_are_their_spec_slices(mesh_run, inputs, arch):
    """The placed shards against the test's own slicing, bit for bit; on
    (2, 2) some leaf is split over ``data`` and some over ``model``."""
    cfg, shape = inputs[arch]["tcfg"], mesh_run["shape"]
    specs = tree.leaves(SH.param_specs(TM.init_params(cfg, None, "meta"),
                                       _policy(shape)), is_leaf=SH.is_spec)
    split = set()
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"train_{arch}_sgd_r{r}"]
        assert list(got["coord"]) == [_coord(r, shape)["data"],
                                      _coord(r, shape)["model"]]
        for i, (a, spec) in enumerate(zip(inputs[arch]["leaves"], specs)):
            want = _spec_slice(a, spec, shape, _coord(r, shape))
            np.testing.assert_array_equal(got[f"i{i}"], want)
            for d, entry in enumerate(spec):
                for ax in SH.axes_of(entry):
                    if got[f"i{i}"].shape[d] < a.shape[d]:
                        split.add(ax)
    want = {"data", "model"} if shape == (2, 2) else {"data"}
    assert split == want, split


def _jax_drops(inputs):
    """The dropped assignments of every moe layer of each microbatch, in
    the JAX package: its router's choices on the microbatch's tokens,
    counted against the capacity (an expert keeps its first C)."""
    case = inputs["deepseek-moe-16b"]
    jcfg = case["jcfg"]
    log = []
    orig = JMOE.apply_moe_sort

    def recording(p, x, cfg, capacity_factor, **kw):
        m = cfg.moe
        C = max(int(m.top_k * x.shape[0] * capacity_factor /
                    m.num_experts), 1)
        _, idx = jax.lax.top_k(JMOE.router_probs(p, x), m.top_k)
        counts = jnp.zeros(m.num_experts, jnp.int32).at[idx.reshape(-1)].add(1)
        jax.debug.callback(lambda d: log.append(int(d)),
                           jnp.sum(jnp.maximum(counts - C, 0)))
        return orig(p, x, cfg, capacity_factor, **kw)

    JMOE.apply_moe_sort = recording
    try:
        p = jax.tree.map(jnp.asarray, case["np_params"])
        rows = R.BATCH // R.MICRO
        per_micro = []
        for i in range(R.MICRO):
            mb = {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                  for k, v in case["batch"].items()}
            log.clear()
            jax.block_until_ready(JM.loss_fn(p, jcfg, JRuntime(remat=False),
                                             mb))
            jax.effects_barrier()
            per_micro.append(list(log))
    finally:
        JMOE.apply_moe_sort = orig
    return per_micro


def test_mesh_moe_drops_match_the_reference(mesh_run, inputs):
    """Each microbatch's dispatches (its forward, then the recompute under
    remat in reverse) drop what the JAX router drops on the microbatch's
    global tokens, and the host mesh's step drops the same."""
    want = _memo("jax_drops", lambda: _jax_drops(inputs))
    n_layers = inputs["deepseek-moe-16b"]["tcfg"].n_layers
    expect = []
    for drops in want:
        assert len(drops) == n_layers and all(d > 0 for d in drops), want
        expect += drops + drops[::-1]
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"train_deepseek-moe-16b_sgd_r{r}"]["drops"]
        assert list(got) == expect
    assert _host_train(inputs, "deepseek-moe-16b", "sgd")[3] == expect


def test_mesh_bf16_accumulation_matches_jax(mesh_run, inputs):
    arch = R.BF16_ARCH
    case = inputs[arch]
    policy = JSH.ShardingPolicy.for_mesh(j_host_mesh(),
                                         grad_accum_dtype="bfloat16")
    ident = JO.Optimizer(lambda p: {}, lambda p, s, g: (g, s), "grads")
    step, n = JST.make_train_step(case["jcfg"], JRuntime(remat=True), ident,
                                  JShape("t", R.SEQ, R.BATCH, "train"),
                                  policy, num_microbatches=R.MICRO)
    assert n == R.MICRO
    jg = jax.jit(lambda p, b: step(p, {}, b)[0])(
        jax.tree.map(jnp.asarray, case["np_params"]), _jnp(case["batch"]))
    grads = _assembled(mesh_run, "bf16", "g", case["tcfg"])
    _close_tree(grads, bridge.params_from_jax(
        jax.tree.map(np.asarray, jg), "cpu"), BF16_TOL, "bf16-accumulated")
    # an fp32 accumulator gives other gradients
    g32, _ = TST.bind_train(TMESH.make_host_mesh("cpu"), case["tcfg"],
                            Runtime(remat=True), TO.sgd(R.LR["sgd"]),
                            R.train_shape(), num_microbatches=R.MICRO)[
        "grads"](R.params_of(case["tcfg"], case["leaves"]),
                 _torch(case["batch"]))
    assert any(not torch.equal(a, b) for a, b in zip(tree.leaves(grads),
                                                     tree.leaves(g32)))


@pytest.mark.parametrize("arch", R.ARCHS)
def test_mesh_serve_matches_host_mesh(mesh_run, inputs, arch):
    logits, toks, _ = _host_serve(inputs, arch)
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"serve_{arch}_r{r}"]
        np.testing.assert_array_equal(got["tokens"], toks.numpy())
        for i in range(len(logits)):
            _close(got["logits"][i], logits[i].numpy(), TOL,
                   f"{arch} rank {r} step {i}")


@pytest.mark.parametrize("arch", R.ARCHS)
def test_mesh_collectives_match_the_specs(mesh_run, inputs, arch):
    """A step's collectives, counted by ``spmd.COLLECTIVES``, are what
    ``spmd.step_collectives`` predicts from its specs: the training step
    (remat: every stacked leaf gathered twice a microbatch) and the
    prefill (the encdec decode runs no encoder, so its decode is not)."""
    cfg, policy = inputs[arch]["tcfg"], _policy(mesh_run["shape"])
    pshape = TM.init_params(cfg, None, "meta")
    pspecs = SH.param_specs(pshape, policy)
    got = mesh_run["out"][f"train_{arch}_sgd_r0"]
    want = SP.step_collectives(pshape, pspecs, policy, passes=2,
                               backward=True, micro=R.MICRO)
    assert {k: int(got[f"c_{k}"]) for k in SP.KINDS} == want
    served = mesh_run["out"][f"serve_{arch}_r0"]
    want = SP.step_collectives(
        pshape, pspecs, policy, gather_logits=True,
        cache_shape=TM.init_cache(cfg, R.SERVE_BATCH, R.MAX_SEQ,
                                  device="meta"))
    assert {k: int(served[f"c0_{k}"]) for k in SP.KINDS} == want
    assert want["all_gather"] > 0 and want["reduce_scatter"] == 0


def test_drivers_run_on_the_process_group(mesh_run, inputs):
    """(4, 1) only: ``serve`` and ``run_arch`` on ``make_host_mesh``'s
    DeviceMesh give the host runs' tokens and losses, and ``run_arch``'s
    checkpoint holds the host run's parameters."""
    if mesh_run["shape"][1] != 1:
        assert not any(k.startswith("drivers") for k in mesh_run["out"])
        return
    cfg = R.config(R.BF16_ARCH)
    served = _memo("drv_serve", lambda: TS.serve(cfg, **R.DRIVER_SERVE,
                                                 device="cpu"))
    trained = _memo("drv_train", lambda: TTR.run_arch(cfg, **R.DRIVER_TRAIN,
                                                      device="cpu"))
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"drivers_r{r}"]
        np.testing.assert_array_equal(got["tokens"],
                                      served["tokens"].numpy())
        np.testing.assert_allclose(got["losses"], trained["losses"],
                                   rtol=TOL)
    # one checkpoint, written by rank 0: the whole gathered state
    store = CheckpointStore(str(mesh_run["dir"] / "ckpt"))
    assert store.versions() == [1]
    saved, meta = store.load(1)
    assert meta == {"step": R.DRIVER_TRAIN["steps"]}
    _close_tree(bridge.params_from_jax(saved["params"], "cpu"),
                trained["params"], TOL, "checkpointed params")


def test_checkpoint_gathers_one_leaf_at_a_time(mesh_run, inputs):
    """(4, 1) only: ``run_arch``'s checkpoint on the DeviceMesh gathers
    each leaf of params and optimizer state once, on every rank, and no
    rank holds two gathered leaves at once."""
    if mesh_run["shape"][1] != 1:
        assert not any(k.startswith("drivers") for k in mesh_run["out"])
        return
    trained = _memo("drv_train", lambda: TTR.run_arch(
        R.config(R.BF16_ARCH), **R.DRIVER_TRAIN, device="cpu"))
    n_leaves = len(tree.leaves({"params": trained["params"],
                                "opt": trained["opt_state"]}))
    for r in range(mesh_run["n"]):
        got = mesh_run["out"][f"drivers_r{r}"]
        assert int(got["full_calls"]) == n_leaves, r
        assert int(got["full_most"]) == 1, r


# ---------------------------------------------------------------------------
# meshes, placements and refusals (no ranks)
# ---------------------------------------------------------------------------

def test_meshes():
    host = TMESH.make_host_mesh("cpu")
    assert isinstance(host, TMESH.AbstractMesh)
    assert host.shape == (1, 1) and host.mesh_dim_names == ("data", "model")
    assert host.device == torch.device("cpu")
    single = TMESH.make_production_mesh()
    multi = TMESH.make_production_mesh(multi_pod=True)
    for mesh, names, sizes in ((single, ("data", "model"), (16, 16)),
                               (multi, ("pod", "data", "model"),
                                (2, 16, 16))):
        pol = SH.ShardingPolicy.for_mesh(mesh)
        assert (pol.axis_names, pol.axis_sizes) == (names, sizes)
        assert pol.n_devices == int(np.prod(sizes))
        with pytest.raises(ValueError, match="abstract mesh"):
            TST.bind_decode(mesh, R.config("stablelm-1.6b"), Runtime(),
                            InputShape("d", 16, 32, "decode"))
    assert TMESH.PEAK_FLOPS_BF16 == 989e12 and TMESH.HBM_BW == 3.35e12


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_train_step_without_donation(inputs, opt_name):
    """``donate=False`` keeps the given params and optimizer state whole
    and unchanged, and the step returns what the donating step returns;
    the donating step empties the trees it was given."""
    case = inputs["stablelm-1.6b"]
    cfg, batch = case["tcfg"], _torch(case["batch"])
    outs, given = [], []
    for donate in (False, True):
        opt = TO.make(opt_name, R.LR[opt_name])
        bound = TST.bind_train(TMESH.make_host_mesh("cpu"), cfg,
                               Runtime(remat=True), opt, R.train_shape(),
                               num_microbatches=R.MICRO, donate=donate)
        params = R.params_of(cfg, case["leaves"])
        state = opt.init(params)
        before = [t.clone() for t in tree.leaves((params, state))]
        outs.append(bound["step"](params, state, batch))
        given.append((params, state, before))
    params, state, before = given[0]
    after = tree.leaves((params, state))
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    (p0, s0, m0), (p1, s1, m1) = outs
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves((p0, s0)), tree.leaves((p1, s1)), strict=True))
    assert {k: float(v) for k, v in m0.items()} == \
        {k: float(v) for k, v in m1.items()}
    params, state, _ = given[1]
    assert params == {} and state == {}


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert SH.placements(names, SH.P(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.placements(names, SH.P(None, "data")) == [
        Replicate(), Shard(1), Replicate()]
    assert SH.placements(names, SH.P()) == [Replicate()] * 3
    for bad in (SH.P(("data", "pod")), SH.P("data", "data"), SH.P("x")):
        with pytest.raises(ValueError):
            SH.placements(names, bad)
    # named: a tree of specs as placements on a mesh's axes
    mesh = TMESH.make_production_mesh(multi_pod=True)
    assert SH.named(mesh, {"w": SH.P(None, "model"), "s": SH.P()}) == {
        "w": [Replicate(), Replicate(), Shard(1)], "s": [Replicate()] * 3}


def test_local_slice_is_the_spec_slice():
    a = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    sizes = {"pod": 2, "data": 2, "model": 2}
    spec = SH.P(("pod", "data"), None, "model")
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                coord = {"pod": pod, "data": data, "model": model}
                got = SP.local_slice(torch.from_numpy(a), spec, sizes, coord)
                want = a[2 * pod + data:2 * pod + data + 1, :,
                         4 * model:4 * model + 4]
                np.testing.assert_array_equal(got.numpy(), want)
