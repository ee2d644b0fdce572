"""The port's transformer training path (``launch/train.py --arch``)
against the JAX package, on the CPU.

JAX's ``init_params`` of a smoke config crosses into the port through
``bridge.params_from_jax`` (biases and norm scales made random in numpy, so
they count), and the same token batches (``RandomState``) go through
``repro.distributed.steps.bind_train`` on the one-device host mesh and the
port's ``bind_train``: two microbatches, remat on. stablelm-1.6b's smoke
config covers LayerNorm, partial RoPE and MHA; qwen1.5-110b's covers
``RMSNorm`` (the ``rmsnorm`` kernel's plain version under autograd), GQA
and the QKV bias; nemotron-4-340b's at its published head width, 192,
covers squared ReLU and the width the wide tensor-core backward serves on
the card. JAX runs at ``highest`` matmul precision
(``tests/conftest.py``). The two compute the same fp32 math in other
orders, so the numbers agree within tolerances, not bit for bit:

- the step-1 loss within 2e-5 relative, each accumulated gradient leaf
  within 2e-5 of its max |g| (``tests/test_kernels.py::_tol``, fp32);
- 3 SGD steps: every parameter within 2e-5 (SGD is linear in g, so a
  gradient's rounding moves a parameter by lr times as much);
- 3 AdamW steps: each step's loss within 1e-4 relative (AdamW divides by
  sqrt(v), which turns a last-bit difference of a tiny gradient into a
  visible step, so the parameters are not compared);
- the optimizers alone, fed JAX's gradients: JAX's parameters and state
  within 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.checkpoint.store import CheckpointStore as JStore
from repro.configs.base import InputShape as JShape
from repro.data import tokens as JT
from repro.distributed import sharding as JSH
from repro.distributed import steps as JST
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.models.runtime import Runtime as JRuntime
from repro.optim import optimizers as JO
from repro_torch import bridge, tree
from repro_torch.configs.base import InputShape
from repro_torch.data import tokens as TT
from repro_torch.distributed import steps as TST
from repro_torch.launch import train as TRAIN
from repro_torch.launch.mesh import make_host_mesh as t_host_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.runtime import Runtime
from repro_torch.optim import optimizers as TO

ARCHS = ["stablelm-1.6b", "qwen1.5-110b"]
BATCH, SEQ, MICRO = 4, 16, 2
LOSS_RTOL, GRAD_TOL = 2e-5, 2e-5
SGD_TOL, ADAM_LOSS_RTOL, OPT_TOL = 2e-5, 1e-4, 1e-6
SGD_LR, ADAM_LR = 0.1, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke shapes: one intra-op thread is as fast, and it leaves the other
    cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(jcfg, seed=0):
    """JAX's params as numpy, with biases and norm scales drawn at random
    (JAX initialises them to 0 and 1)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(
        seed)))

    def perturb(path, a):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "bias"):
            return (rng.randn(*a.shape) * 0.02).astype(a.dtype)
        if name == "scale":
            return (1 + rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _batches(vocab, n, seed=3):
    """n token batches as ``repro.launch.train`` draws them: one
    ``RandomState(seed)``, one ``randint`` a step."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=(BATCH, SEQ + 1)).astype(np.int32)
            for _ in range(n)]


def _grads_jax(jcfg, n_micro):
    """JAX's ``make_train_step`` with an optimizer that hands back the
    gradients it is given: (grads, metrics) of one step, jitted."""
    ident = JO.Optimizer(lambda p: {}, lambda p, s, g: (g, s), "grads")
    policy = JSH.ShardingPolicy.for_mesh(make_host_mesh())
    step, n = JST.make_train_step(jcfg, JRuntime(remat=True), ident,
                                  JShape("t", SEQ, BATCH, "train"), policy,
                                  num_microbatches=n_micro)
    assert n == n_micro
    fn = jax.jit(lambda p, b: step(p, {}, b))
    return lambda p, b: (lambda out: (out[0], out[2]))(fn(p, b))


def _bind_port(tcfg, opt, n_micro=MICRO):
    return TST.bind_train(t_host_mesh("cpu"), tcfg, Runtime(remat=True),
                          opt, InputShape("t", SEQ, BATCH, "train"),
                          num_microbatches=n_micro)


def _close_tree(got, want, tol, what):
    """Each leaf of ``got`` (tensors) within ``tol`` of its max |want|."""
    for path_leaf, (g, w) in enumerate(zip(tree.leaves(got),
                                           jax.tree.leaves(want),
                                           strict=True)):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.detach().float().numpy() - w).max())
        assert err <= tol * scale, (what, path_leaf, err, scale)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """Per arch: the configs, the JAX params (numpy) and four batches."""
    arch = request.param
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    assert jcfg.dtype == tcfg.dtype == "float32"
    np_params = _jax_params(jcfg)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                batches=_batches(jcfg.vocab, 3))


@pytest.fixture(scope="module")
def step1(case):
    """One step's accumulated gradients and metrics in both packages."""
    jgrads, jm = _grads_jax(case["jcfg"], MICRO)(
        jax.tree.map(jnp.asarray, case["np_params"]),
        {"tokens": jnp.asarray(case["batches"][0])})
    bound = _bind_port(case["tcfg"], TO.adamw(ADAM_LR))
    tgrads, tm = bound["grads"](
        bridge.params_from_jax(case["np_params"], "cpu"),
        {"tokens": torch.from_numpy(case["batches"][0])})
    return jgrads, jm, tgrads, tm


def test_step1_loss_matches_jax(step1):
    _, jm, _, tm = step1
    assert set(tm) == {"loss", "ce", "aux"}
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


def test_step1_accumulated_grads_match_jax(step1):
    jgrads, _, tgrads, _ = step1
    assert all(g.dtype == torch.float32 for g in tree.leaves(tgrads))
    _close_tree(tgrads, jgrads, GRAD_TOL, "grads")


def test_step1_grads_reach_every_leaf(step1):
    """No leaf of the port's gradient is all zero (a detached path would
    leave one so), and the tree is the parameters'."""
    _, _, tgrads, _ = step1
    assert all(float(g.abs().max()) > 0 for g in tree.leaves(tgrads))


def _jax_steps(case, opt, n):
    bound = JST.bind_train(make_host_mesh(), case["jcfg"],
                           JRuntime(remat=True), opt,
                           JShape("t", SEQ, BATCH, "train"),
                           num_microbatches=MICRO, donate=False)
    assert bound["n_micro"] == MICRO
    p = jax.tree.map(jnp.asarray, case["np_params"])
    s = opt.init(p)
    losses = []
    for b in case["batches"][:n]:
        p, s, m = bound["step"](p, s, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    return p, s, losses


def _port_steps(case, opt, n):
    bound = _bind_port(case["tcfg"], opt)
    p = bridge.params_from_jax(case["np_params"], "cpu")
    s = opt.init(p)
    losses = []
    for b in case["batches"][:n]:
        p, s, m = bound["step"](p, s, {"tokens": torch.from_numpy(b)})
        losses.append(float(m["loss"]))
    return p, s, losses


def test_three_sgd_steps_match_jax(case):
    jp, js, jl = _jax_steps(case, JO.sgd(SGD_LR), 3)
    tp, ts, tl = _port_steps(case, TO.sgd(SGD_LR), 3)
    np.testing.assert_allclose(tl, jl, rtol=ADAM_LOSS_RTOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    for t, j in zip(tree.leaves(tp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=SGD_TOL)


def test_three_adamw_steps_losses_match_jax(case):
    _, js, jl = _jax_steps(case, JO.adamw(ADAM_LR), 3)
    tp, ts, tl = _port_steps(case, TO.adamw(ADAM_LR), 3)
    np.testing.assert_allclose(tl, jl, rtol=ADAM_LOSS_RTOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.1}),
                                     ("rmsprop", {})])
def test_optimizer_on_jax_grads_matches_jax(case, step1, name, kw):
    """Two updates from JAX's state (carried by ``bridge``) on JAX's
    accumulated gradients: the parameters and every state leaf within
    1e-6."""
    jgrads = step1[0]
    lr = SGD_LR if name == "sgd" else ADAM_LR
    jopt, topt = JO.make(name, lr, **kw), TO.make(name, lr, **kw)
    jp = jax.tree.map(jnp.asarray, case["np_params"])
    js = jopt.init(jp)
    tp = bridge.params_from_jax(case["np_params"], "cpu")
    ts = bridge.opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    tg = bridge.params_from_jax(jax.tree.map(np.asarray, jgrads), "cpu")
    for _ in range(2):
        jp, js = jopt.update(jp, js, jgrads)
        tp, ts = topt.update(tp, ts, tg)
    assert sorted(ts) == sorted(js)
    for t, j in zip(tree.leaves((tp, ts)), jax.tree.leaves((jp, js)),
                    strict=True):
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=OPT_TOL)


@pytest.mark.parametrize("n_micro", [1, 4])
def test_microbatch_count_does_not_change_the_grads(case, step1, n_micro):
    """The reference's ``test_grad_accumulation_invariance`` in the port:
    1 and 4 microbatches give the 2-microbatch gradients within 2e-5 of
    each leaf's max |g|, and the same loss."""
    bound = _bind_port(case["tcfg"], TO.sgd(SGD_LR), n_micro)
    assert bound["n_micro"] == n_micro
    grads, m = bound["grads"](
        bridge.params_from_jax(case["np_params"], "cpu"),
        {"tokens": torch.from_numpy(case["batches"][0])})
    _, _, tgrads, tm = step1
    _close_tree(grads, bridge.to_numpy(tgrads), GRAD_TOL, "micro")
    np.testing.assert_allclose(float(m["loss"]), float(tm["loss"]),
                               rtol=LOSS_RTOL)


def test_microbatch_count_matches_jax():
    policy = JSH.ShardingPolicy.for_mesh(make_host_mesh())
    from repro_torch.distributed.sharding import ShardingPolicy
    for b, want in [(8, 0), (8, 3), (8, 4), (6, 4), (1, 16), (16, 16),
                    (12, 5)]:
        shape = InputShape("t", 4, b, "train")
        assert TST._microbatch_count(shape, ShardingPolicy(), want) == \
            JST._microbatch_count(JShape("t", 4, b, "train"), policy, want)


def test_one_microbatch_hands_raw_grads_to_the_optimizer():
    """With one microbatch the gradients keep the parameters' dtype (the
    reference's ``n_micro == 1`` branch); with more they are the fp32
    mean."""
    cfg = TC.get_smoke("qwen1.5-110b").replace(dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(_batches(cfg.vocab, 1)[0])}
    for n, dt in ((1, torch.bfloat16), (2, torch.float32)):
        grads, _ = _bind_port(cfg, TO.sgd(0.1), n)["grads"](params, batch)
        assert {g.dtype for g in tree.leaves(grads)} == {dt}


# ---------------------------------------------------------------------------
# model pieces, data, the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in TC.ARCH_IDS
                                  if TC.get(a).family == "dense"])
def test_param_count_and_batch_spec_match_jax(arch):
    for get in ("get", "get_smoke"):
        jcfg, tcfg = getattr(JC, get)(arch), getattr(TC, get)(arch)
        assert TM.param_count(tcfg) == JM.param_count(jcfg)
        shape = InputShape("t", 64, 8, "train")
        spec = TM.train_batch_spec(tcfg, shape)
        jspec = JM.train_batch_spec(jcfg, JShape("t", 64, 8, "train"))
        assert {k: (tuple(s.shape), s.dtype) for k, s in spec.items()} == {
            k: (tuple(s.shape), torch.int32) for k, s in jspec.items()}


def test_stablelm_full_param_count():
    """The full-width leg's model: 1,644,367,872 parameters."""
    assert TM.param_count(TC.get("stablelm-1.6b")) == \
        JM.param_count(JC.get("stablelm-1.6b")) == 1_644_367_872


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    np_params = _jax_params(jcfg, seed=5)
    toks = _batches(jcfg.vocab, 1, seed=7)[0]
    jl, jm = JM.loss_fn(jax.tree.map(jnp.asarray, np_params), jcfg,
                        JRuntime(remat=False), {"tokens": jnp.asarray(toks)})
    tl, tm = TM.loss_fn(bridge.params_from_jax(np_params, "cpu"), tcfg,
                        Runtime(remat=False),
                        {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(tm["aux"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_path_matches_materialised_attention(arch, monkeypatch):
    """The training path's attention (``FlashAttention``, its backward over
    kv chunks) gives the loss and gradients of autograd through
    ``layers.plain_attention`` (materialised scores), with remat on and
    off."""
    cfg = TC.get_smoke(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = {"tokens": torch.from_numpy(_batches(cfg.vocab, 1)[0])}

    def grads(remat):
        bound = TST.bind_train(t_host_mesh("cpu"), cfg, Runtime(remat=remat),
                               TO.sgd(0.1),
                               InputShape("t", SEQ, BATCH, "train"),
                               num_microbatches=MICRO)
        return bound["grads"](params, batch)

    out = [grads(True), grads(False)]

    def materialised(q, k, v, *, causal, window):
        pos = torch.arange(q.shape[1], dtype=torch.int32)
        return TL.plain_attention(q, k, v, pos.expand(q.shape[0], -1), pos,
                                  causal=causal, window=window)

    monkeypatch.setattr(TL.ops, "attention", materialised)
    out += [grads(True), grads(False)]
    (g0, m0), *rest = out
    for g, m in rest:
        np.testing.assert_allclose(float(m["loss"]), float(m0["loss"]),
                                   rtol=LOSS_RTOL)
        _close_tree(g, bridge.to_numpy(g0), GRAD_TOL, "attention")


def test_lm_batch_and_shard_slice_match_jax():
    for arch in ("stablelm-1.6b", "whisper-base", "internvl2-1b"):
        jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
        for step in (0, 3):
            j = JT.lm_batch(jcfg, 4, 16, seed=2, step=step)
            t = TT.lm_batch(tcfg, 4, 16, seed=2, step=step)
            assert sorted(j) == sorted(t)
            for k in j:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])
            for shard in range(2):
                js, ts = JT.shard_slice(j, shard, 2), TT.shard_slice(t, shard,
                                                                     2)
                for k in j:
                    np.testing.assert_array_equal(ts[k], js[k])
    with pytest.raises(ValueError, match="does not split"):
        TT.shard_slice({"tokens": np.zeros((3, 2))}, 0, 2)


def test_sample_batch_draws_the_reference_tokens():
    """``launch.train.sample_batch`` draws what ``repro.launch.train`` does
    from the same ``RandomState``, step after step."""
    cfg = TC.get_smoke("stablelm-1.6b")
    spec = TM.train_batch_spec(cfg, InputShape("t", SEQ, BATCH, "train"))
    rng = np.random.RandomState(11)
    want = np.random.RandomState(11)
    for _ in range(3):
        got = TRAIN.sample_batch(rng, spec, cfg.vocab, "cpu")["tokens"]
        ref = np.asarray(jnp.asarray(want.randint(
            0, cfg.vocab, size=(BATCH, SEQ + 1)), jnp.int32))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_train_main_arch_cpu_runs_and_checkpoints(tmp_path, capsys):
    """``main(["--arch", ...])`` on the CPU: finite losses printed each
    step, a checkpoint the JAX package's store loads, whose params are the
    run's."""
    ck = tmp_path / "ck"
    assert TRAIN.main(["--arch", "stablelm-1.6b", "--steps", "2", "--batch",
                       "4", "--seq", "16", "--micro", "2", "--device", "cpu",
                       "--ckpt", str(ck), "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.strip().startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "[arch] stablelm-1.6b (smoke) params=460,032 micro=2" in out
    assert "checkpoint v1" in out
    j_tree, j_meta = JStore(str(ck)).load(1)
    assert j_meta == {"step": 2}
    assert sorted(j_tree["opt"]) == ["m", "step", "v"]
    assert int(j_tree["opt"]["step"]) == 2


def test_run_arch_returns_the_checkpointed_state(tmp_path):
    cfg = TRAIN.arch_config("qwen1.5-110b")
    res = TRAIN.run_arch(cfg, steps=2, ckpt=str(tmp_path), ckpt_every=1,
                         batch=4, seq=8, micro=2, optimizer="sgd",
                         device="cpu")
    assert res["store"].versions() == [1, 2] and res["n_micro"] == 2
    loaded, meta = res["store"].load(2)
    assert meta == {"step": 2}
    for a, b in zip(tree.leaves(res["params"]),
                    tree.leaves(loaded["params"]), strict=True):
        assert torch.equal(a, torch.from_numpy(np.asarray(b)))
    assert len(res["step_s"]) == len(res["launches"]) == 2
    # the CPU runs the plain versions: no kernel launch
    assert res["launches"][0] == {"flash_attention": 0, "flash_lse": 0,
                                  "flash_bwd": 0, "rmsnorm": 0,
                                  "rmsnorm_bwd": 0}


def test_train_main_needs_a_mode():
    with pytest.raises(SystemExit, match="--paper or --arch"):
        TRAIN.main([])


@pytest.fixture(scope="module")
def nemotron_hd192():
    """nemotron-4-340b's smoke config at the published head width, 192
    (d_model 128 over 4 heads: the projections widen to 4 x 192), in both
    packages, with JAX's params and one batch."""
    jcfg = JC.get_smoke("nemotron-4-340b").replace(head_dim=192)
    tcfg = TC.get_smoke("nemotron-4-340b").replace(head_dim=192)
    assert jcfg.hd == tcfg.hd == 192
    assert (tcfg.mlp, tcfg.norm, tcfg.rope_fraction) == (
        "squared_relu", "layernorm", 0.5)
    np_params = _jax_params(jcfg)
    batch = _batches(jcfg.vocab, 1)[0]
    jgrads, jm = _grads_jax(jcfg, MICRO)(
        jax.tree.map(jnp.asarray, np_params), {"tokens": jnp.asarray(batch)})
    tgrads, tm = _bind_port(tcfg, TO.sgd(SGD_LR))["grads"](
        bridge.params_from_jax(np_params, "cpu"),
        {"tokens": torch.from_numpy(batch)})
    return jgrads, jm, tgrads, tm


def test_nemotron_hd192_step_loss_matches_jax(nemotron_hd192):
    """One step of the config whose attention the tensor-core backward at hd
    192 serves on the card (here the plain backward, on the CPU)."""
    _, jm, _, tm = nemotron_hd192
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL)


def test_nemotron_hd192_step_grads_match_jax(nemotron_hd192):
    jgrads, _, tgrads, _ = nemotron_hd192
    _close_tree(tgrads, jgrads, GRAD_TOL, "nemotron hd 192 grads")
    assert all(float(g.abs().max()) > 0 for g in tree.leaves(tgrads))
