"""The port's encdec family (whisper-base's smoke config: a 2-layer encoder
over 32 stubbed frame embeddings, a 2-layer decoder with cross-attention,
LayerNorm, GELU, QKV bias, sinusoidal positions, tied embeddings) against
the JAX package, on the CPU: ``sinusoidal_positions``, ``cross_attention``
(over the memory and over its projected k/v), ``_encode``, ``forward``, the
training loss and every gradient leaf against ``jax.grad``, prefill +
greedy decode with every cache leaf (``k``, ``v``, ``ck``, ``cv``), decode
against the port's own forward, a bf16 forward, the published config's
parameter count and specs, the training batches' draws, and the entry
points (``serve()``, ``launch/train.py --arch``) on the CPU.

JAX's ``init_params`` crosses into the port through
``bridge.params_from_jax`` (biases and norm scales drawn at random in
numpy, so they count); tokens and frames come from a numpy seed. fp32; JAX
at ``highest`` matmul precision (``tests/conftest.py``): within 2e-5 of
scale (``tests/test_kernels.py::_tol``), the greedy tokens equal; bf16
within 2e-2. The helpers are shared with ``tests/test_torch_vlm.py``.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.runtime import Runtime as JRuntime
from repro_torch import bridge, tree
from repro_torch.configs.base import InputShape
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as S
from repro_torch.launch import train as TRAIN
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.runtime import DEFAULT, Runtime

ARCH = "whisper-base"
TOL, BF16_TOL = 2e-5, 2e-2
# tests/test_models.py::test_decode_matches_forward
DECODE_TOL = 2e-4
PROMPT, BATCH, STEPS = 9, 2, 3
# the published config's parameters, as repro.models.model.param_count
PUBLISHED_PARAMS = 70_655_488
NO_LAUNCHES = {"rmsnorm": 0, "flash_attention": 0, "rmsnorm_bwd": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers (tests/test_torch_vlm.py imports them)
# ---------------------------------------------------------------------------

def jax_params(jcfg, seed=0):
    """JAX's params as numpy, with biases and norm scales drawn at random
    (JAX initialises them to 0 and 1)."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(
        seed)))

    def perturb(path, a):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "bias"):
            return (rng.randn(*a.shape) * 0.1).astype(a.dtype)
        if name == "scale":
            return (1 + rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def make_batch(cfg, B, St, seed):
    """Numpy tokens [B, St] and the family's float entry (``frames`` or
    ``patches``), from one seed."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab, size=(B, St)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(
            np.float32)
    else:
        out["patches"] = rng.randn(B, cfg.vision_prefix, cfg.d_model).astype(
            np.float32)
    return out


def to_jax(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v, jnp.int32 if k == "tokens" else dtype)
            for k, v in batch.items()}


def to_torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v) if k == "tokens" else
            torch.from_numpy(v).to(dtype) for k, v in batch.items()}


def close(got, want, what, tol=TOL):
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, f"{what}: max|port - jax| / max|jax| = {err:.3e}"


def names(t):
    return [".".join(map(str, k)) for k in tree.leaf_paths(t)]


def jax_names(t):
    return [".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(t)[0]]


def prefix(cfg):
    return cfg.vision_prefix if cfg.family == "vlm" else 0


def check_forward(jcfg, tcfg, p):
    b = make_batch(jcfg, 2, 11, seed=2)
    jl, ja = jax.jit(JM.forward, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, p), jcfg, JRuntime(remat=False), to_jax(b))
    tl, ta = TM.forward(bridge.params_from_jax(p, "cpu"), tcfg, DEFAULT,
                        to_torch(b))
    assert tl.shape == (2, 11, tcfg.padded_vocab)
    close(tl, jl, "logits")
    assert float(ta) == float(ja) == 0.0


def check_prefill_and_decode(jcfg, tcfg, p):
    """Prefill + STEPS greedy decode steps: logits and tokens each step,
    then every cache leaf, against JAX's (the decode from ``prefix +
    PROMPT``)."""
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_jax(p, "cpu")
    b = make_batch(jcfg, BATCH, PROMPT, seed=1)
    start = prefix(tcfg) + PROMPT
    max_seq = start + STEPS + 8
    jrt = JRuntime(remat=False)
    jl, jc = jax.jit(JM.prefill, static_argnums=(1, 2))(
        jp, jcfg, jrt, to_jax(b), JM.init_cache(jcfg, BATCH, max_seq))
    tc = TM.init_cache(tcfg, BATCH, max_seq)
    assert names(tc) == jax_names(jc)
    tl, tc = TM.prefill(tp, tcfg, DEFAULT, to_torch(b), tc)
    jdec = jax.jit(JM.decode_step, static_argnums=(1, 2))
    for s in range(STEPS + 1):
        close(tl, jl, f"logits, step {s}")
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), S.greedy(tl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        if s == STEPS:
            break
        jl, jc = jdec(jp, jcfg, jrt, jt, jc, jnp.int32(start + s))
        tl, tc = TM.decode_step(tp, tcfg, DEFAULT, tt, tc, start + s)
    for name, t, a in zip(names(tc), tree.leaves(tc), jax.tree.leaves(jc),
                          strict=True):
        close(t, a, f"cache {name}")
    return names(tc)


def check_decode_matches_forward(tcfg, p):
    """prefill(S) then decode(1) equal forward(S + 1)'s last two rows, on
    the port alone."""
    tp = bridge.params_from_jax(p, "cpu")
    b = to_torch(make_batch(tcfg, 2, 11, seed=0))
    Sq = 10
    full, _ = TM.forward(tp, tcfg, DEFAULT, b)
    cache = TM.init_cache(tcfg, 2, prefix(tcfg) + Sq + 4)
    pre, cache = TM.prefill(tp, tcfg, DEFAULT,
                            dict(b, tokens=b["tokens"][:, :Sq]), cache)
    np.testing.assert_allclose(pre.numpy(), full[:, Sq - 1].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    dec, _ = TM.decode_step(tp, tcfg, DEFAULT, b["tokens"][:, Sq], cache,
                            prefix(tcfg) + Sq)
    np.testing.assert_allclose(dec.numpy(), full[:, Sq].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def loss_and_grads(jcfg, tcfg, p):
    """JAX's (loss, metrics) and gradients of ``loss_fn`` (remat on), and
    the port's, on one batch of 13 tokens a row."""
    b = make_batch(jcfg, 2, 13, seed=4)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                           static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, p), jcfg, JRuntime(remat=True), to_jax(b))
    leaves, spec = tree.flatten(bridge.params_from_jax(p, "cpu"))
    ps = [t.requires_grad_() for t in leaves]
    tl, tm = TM.loss_fn(tree.unflatten(spec, ps), tcfg, Runtime(remat=True),
                        to_torch(b))
    tg = torch.autograd.grad(tl, ps)
    return jl, jm, jg, tl, tm, tree.unflatten(spec, list(tg))


def check_loss(res):
    jl, jm, _, tl, tm, _ = res
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]),
                               rtol=TOL)


def check_grads(res, rope: bool):
    """Every gradient leaf within TOL of its max |g|, none all zero; but
    without RoPE a key bias adds one constant to a query's scores over all
    keys, which the softmax takes out: its gradient is 0, so both packages'
    (rounding noise) must lie within TOL of the key projection's."""
    _, _, jg, _, _, tg = res
    got = dict(zip(names(tg), tree.leaves(tg)))
    for (name, g), w in zip(got.items(), jax.tree.leaves(jg), strict=True):
        if name.endswith(".bk") and not rope:
            wk = float(got[name[:-2] + "wk"].abs().max())
            assert max(float(g.abs().max()),
                       float(np.abs(w).max())) <= TOL * wk, name
            continue
        close(g, w, name)
        assert float(g.abs().max()) > 0, name
    return list(got)


def check_bf16_forward(jcfg, tcfg):
    """The smoke config in bf16, JAX's tree across the bridge bit for bit,
    the forward's logits within 2e-2."""
    jcfg, tcfg = jcfg.replace(dtype="bfloat16"), tcfg.replace(
        dtype="bfloat16")
    p = jax_params(jcfg, seed=5)
    tp = bridge.params_from_jax(p, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(tp))
    b = make_batch(jcfg, 2, 11, seed=6)
    jl, _ = jax.jit(JM.forward, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, p), jcfg, JRuntime(remat=False),
        to_jax(b, jnp.bfloat16))
    tl, _ = TM.forward(tp, tcfg, DEFAULT, to_torch(b, torch.bfloat16))
    close(tl, jl, "bf16 logits", BF16_TOL)


def check_published(arch, want_params):
    """param_count, train_batch_spec and decode_spec of the published config
    equal the reference's."""
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    assert TM.param_count(tcfg) == JM.param_count(jcfg) == want_params
    assert TM.param_count(tcfg, active_only=True) == want_params
    shape = ("train_4k", 4096, 8, "train")
    tspec = TM.train_batch_spec(tcfg, InputShape(*shape))
    jspec = JM.train_batch_spec(jcfg, JShape(*shape))
    assert list(tspec) == list(jspec)
    for k in tspec:
        assert tspec[k].shape == jspec[k].shape, k
        assert str(tspec[k].dtype).split(".")[-1] == str(jspec[k].dtype), k
    dshape = ("d", 64, 4, "decode")
    tdec = TM.decode_spec(tcfg, InputShape(*dshape))
    jdec = JM.decode_spec(jcfg, JShape(*dshape))
    assert [(s.shape, str(s.dtype).split(".")[-1]) for s in tdec] == \
        [(s.shape, str(s.dtype)) for s in jdec]


def check_sample_batch(arch, dtype):
    """``sample_batch``'s draws bit-equal to ``repro.launch.train``'s
    (``randint`` for tokens, ``jnp.asarray(rng.randn(*shape), dtype)``
    for the float entry, in the spec's key order), three steps."""
    tcfg = TC.get_smoke(arch).replace(dtype=dtype)
    jcfg = JC.get_smoke(arch).replace(dtype=dtype)
    shape = ("t", 16, 4, "train")
    tspec = TM.train_batch_spec(tcfg, InputShape(*shape))
    jspec = JM.train_batch_spec(jcfg, JShape(*shape))
    got_rng, want_rng = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        got = TRAIN.sample_batch(got_rng, tspec, tcfg.vocab, "cpu")
        assert list(got) == list(jspec)
        for k, s in jspec.items():
            if s.dtype == jnp.int32:
                want = np.asarray(jnp.asarray(want_rng.randint(
                    0, jcfg.vocab, size=s.shape), jnp.int32))
            else:
                want = np.asarray(jnp.asarray(want_rng.randn(*s.shape),
                                              s.dtype))
            assert got[k].dtype == tspec[k].dtype
            np.testing.assert_array_equal(
                bridge.to_numpy(got[k]).view(np.uint8), want.view(np.uint8),
                err_msg=k)


def check_serve_on_the_cpu(arch):
    cfg = TC.get_smoke(arch)
    before = (RN.rmsnorm.launches, FA.flash_attention.launches)
    res = S.serve(cfg, requests=3, batch=2, prompt=6, tokens=4, seed=0,
                  device="cpu")
    toks = res["tokens"]
    assert toks.shape == (3, 4) and toks.dtype == torch.int32
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    # on the CPU the plain versions run: no kernel launch is counted
    assert res["launches"] == NO_LAUNCHES
    assert (RN.rmsnorm.launches, FA.flash_attention.launches) == before
    again = S.serve(cfg, requests=3, batch=2, prompt=6, tokens=4, seed=0,
                    device="cpu")
    assert torch.equal(toks, again["tokens"])


def check_train_main(arch, tmp_path, capsys):
    """``main(["--arch", ...])`` on the CPU: finite losses, a checkpoint the
    JAX package's store loads, holding the family's tree."""
    ck = tmp_path / "ck"
    assert TRAIN.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                       "--batch", "4", "--seq", "16", "--micro", "2",
                       "--ckpt", str(ck), "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.strip().startswith("step")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"[arch] {arch} (smoke)" in out and "checkpoint v1" in out
    j_tree, j_meta = JStore(str(ck)).load(1)
    assert j_meta == {"step": 2} and int(j_tree["opt"]["step"]) == 2
    return sorted(j_tree["params"])


# ---------------------------------------------------------------------------
# whisper-base's smoke config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    return jcfg, tcfg, jax_params(jcfg)


@pytest.fixture(scope="module")
def grads(model):
    return loss_and_grads(*model)


def _sublayer(p, which):
    """Unit 0 of a stacked layer's subtree, as numpy."""
    return jax.tree.map(lambda a: a[0], p["decoder"]["l0"][which])


@pytest.mark.parametrize("d_model", [512, 128, 7])
def test_sinusoidal_positions_match_jax(d_model):
    """Over an encoder's [S] positions (whisper's 1,500) and a decode
    step's [B, 1] absolute positions: each value within 2e-5 plus two fp32
    ulps of its angle (position x frequency, rounded to fp32 in both
    packages, whose ``exp`` may differ in the last bit: at position 1,499
    one ulp of the angle is 1.2e-4)."""
    for pos in (np.arange(1500, dtype=np.int32),
                np.array([[0], [447], [1499]], np.int32)):
        got = TL.sinusoidal_positions(torch.from_numpy(pos), d_model)
        want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), d_model))
        assert got.dtype == torch.float32 and got.shape == want.shape
        ang = np.tile(pos[..., None].astype(np.float32), 2 * (d_model // 2))
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert (err <= TOL + 2 * np.spacing(ang)).all(), err.max()


def test_cross_attention_matches_jax(model):
    """Over the memory, and over its projected k/v (the decode cache's
    ck/cv), which gives the same output."""
    jcfg, _, p = model
    cross = _sublayer(p, "cross")
    rng = np.random.RandomState(8)
    x = rng.randn(2, 5, jcfg.d_model).astype(np.float32)
    mem = rng.randn(2, jcfg.encoder_seq, jcfg.d_model).astype(np.float32)
    jrt = JRuntime(remat=False)
    want = JL.cross_attention(jax.tree.map(jnp.asarray, cross),
                              jnp.asarray(x), jcfg, jrt,
                              memory=jnp.asarray(mem))
    tp = bridge.params_from_jax(cross, "cpu")
    tx, tmem = torch.from_numpy(x), torch.from_numpy(mem)
    got = TL.cross_attention(tp, tx, memory=tmem)
    close(got, want, "cross over memory")
    _, k, v = TL.attention_qkv(tp, tx, xkv=tmem)
    assert k.shape == (2, jcfg.encoder_seq, jcfg.n_kv_heads, jcfg.hd)
    close(TL.cross_attention(tp, tx, mem_kv=(k, v)), want, "cross over k/v")


def test_encode_matches_jax(model):
    jcfg, tcfg, p = model
    frames = make_batch(jcfg, 2, 1, seed=9)["frames"]
    want = jax.jit(JM._encode, static_argnums=(0, 1))(
        jcfg, JRuntime(remat=False), jax.tree.map(jnp.asarray, p),
        jnp.asarray(frames))
    got = TM._encode(tcfg, DEFAULT, bridge.params_from_jax(p, "cpu"),
                     torch.from_numpy(frames))
    close(got, want, "encoder memory")


def test_tree_and_wo_scale(model):
    """JAX's tree; the port's own init draws the encoder's ``wo`` at the
    encoder's depth and the decoder's at the decoder's (both 2 here, so one
    config with a deeper encoder tells them apart)."""
    jcfg, tcfg, p = model
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert names(own) == jax_names(p)
    assert sorted(own) == ["decoder", "embed", "enc_norm", "encoder",
                           "final_norm"]
    assert sorted(own["decoder"]["l0"]) == ["attn", "cross", "mlp", "norm1",
                                            "norm2", "norm_x"]
    deep = TM.init_params(tcfg.replace(n_encoder_layers=50),
                          torch.Generator().manual_seed(0), "cpu")
    enc, dec = (deep[s]["l0"]["attn"]["wo"].std().item()
                for s in ("encoder", "decoder"))
    assert 3 < dec / enc < 7      # sqrt(50 / 2) = 5


def test_forward_matches_jax(model):
    check_forward(*model)


def test_prefill_and_decode_match_jax(model):
    got = check_prefill_and_decode(*model)
    assert got == ["l0.ck", "l0.cv", "l0.k", "l0.v"]


def test_decode_matches_forward(model):
    check_decode_matches_forward(model[1], model[2])


def test_loss_matches_jax(grads):
    check_loss(grads)


def test_every_gradient_leaf_matches_jax(grads):
    """The encoder's leaves among them: the gradient crosses the
    cross-attention into the encoder."""
    got = check_grads(grads, rope=False)
    assert "encoder.l0.attn.wq" in got and "decoder.l0.cross.wk" in got


def test_bf16_forward_matches_jax(model):
    check_bf16_forward(*model[:2])


def test_published_config_counts_and_specs():
    check_published(ARCH, PUBLISHED_PARAMS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_batch_draws_like_jax(dtype):
    check_sample_batch(ARCH, dtype)


def test_serve_on_the_cpu():
    check_serve_on_the_cpu(ARCH)


def test_train_main_on_the_cpu(tmp_path, capsys):
    assert check_train_main(ARCH, tmp_path, capsys) == [
        "decoder", "embed", "enc_norm", "encoder", "final_norm"]

