"""The transformer kernels under autograd, against the JAX package, on the
CPU.

``ref.flash_attention_bwd`` (the math of ``repro/models/layers.py::_fa_bwd``
over kv chunks) is held to ``jax.vjp`` of ``repro.models.layers.
flash_attention`` (the JAX package's custom VJP) over the flash sweep of
``tests/test_kernels.py`` (causal, window 37, full; GQA groups of 1, 2, 4
and 8; hd 16, 32, 64, 128; one chunk, and chunks that do not divide S), in
fp32 and bf16, and to torch's autograd through the plain attention; the
plain forward's lse to ``_flash_fwd``'s. ``RMSNorm``'s gradient is held to
``jax.grad`` of ``apply_norm("rmsnorm")``. JAX runs at ``highest`` matmul
precision (``tests/conftest.py``). Tolerances are ``tests/test_kernels.py::
_tol``: 2e-5 fp32, 2e-2 bf16 (both packages compute in fp32 from the same
bf16 inputs and round once to bf16 at the end).

The kernels themselves run only on the card (``chip_smoke.py``); here the
dispatch sends CPU tensors to the plain versions, through the same
``autograd.Function``s the card runs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch import configs as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from repro_torch.models.runtime import Runtime

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, S, H, Kv, hd): the sweep's MHA, GQA (G = 2) and MQA shapes, and G = 4
# at qwen's head width
SHAPES = [(1, 64, 4, 4, 32), (2, 129, 8, 4, 64), (1, 200, 8, 1, 16),
          (1, 96, 8, 2, 128)]
MASKS = [(True, 0), (True, 37), (False, 0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a: np.ndarray, dtype: str):
    """One fp32 numpy array as (jax array, torch tensor) of ``dtype``; a
    bf16 value is rounded once, by JAX, and carried bit for bit."""
    j = jnp.asarray(a).astype(JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


def _inputs(B, S, H, Kv, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    shapes = [(B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd), (B, S, H, hd)]
    return [_both(rng.randn(*s).astype(np.float32), dtype) for s in shapes]


def _jax_vjp(jq, jk, jv, jdo, causal, window, chunk):
    B, S = jq.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    kvpos = jnp.arange(S, dtype=jnp.int32)
    fn = lambda q, k, v: JL.flash_attention(q, k, v, pos, kvpos, causal,
                                            window, chunk)
    out, vjp = jax.vjp(fn, jq, jk, jv)
    return out, vjp(jdo)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("chunk", ["whole", 48])
def test_flash_bwd_matches_jax_vjp(shape, causal, window, dtype, chunk):
    B, S, H, Kv, hd = shape
    chunk = S if chunk == "whole" else chunk
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(*shape, dtype,
                                                         seed=S + hd)
    jout, (jdq, jdk, jdv) = _jax_vjp(jq, jk, jv, jdo, causal, window, chunk)
    out, lse = ref.flash_attention(tq, tk, tv, causal=causal, window=window,
                                   with_lse=True)
    _close(out, jout, TOL[dtype], "out")
    dq, dk, dv = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo,
                                         causal=causal, window=window,
                                         chunk=chunk)
    for name, got, want, t in (("dq", dq, jdq, tq), ("dk", dk, jdk, tk),
                               ("dv", dv, jdv, tv)):
        assert got.dtype == t.dtype and got.shape == t.shape
        _close(got, want, TOL[dtype], name)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_lse_matches_jax_flash_fwd(shape, causal, window):
    """The plain forward's lse [B, H, S] against ``_flash_fwd``'s
    [B, Kv, G, S] folded to [B, H, S] (query head h = kv head * G + g)."""
    B, S, H, Kv, hd = shape
    (jq, tq), (jk, tk), (jv, tv), _ = _inputs(*shape, "float32", seed=hd)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    _, jlse = JL._flash_fwd(jq, jk, jv, pos, jnp.arange(S, dtype=jnp.int32),
                            None, causal=causal, window=window, chunk=32)
    _, lse = ref.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    _close(lse, np.asarray(jlse).reshape(B, H, S), TOL["float32"])


def test_flash_lse_layout_per_head():
    """lse[b, h, s] is the log-sum-exp of query head h's scores, the head
    reading kv head h // G (checked at G = 4 against a loop over heads)."""
    B, S, H, Kv, hd = 2, 40, 8, 2, 16
    (_, tq), (_, tk), (_, tv), _ = _inputs(B, S, H, Kv, hd, "float32", 9)
    _, lse = ref.flash_attention(tq, tk, tv, causal=True, window=7,
                                 with_lse=True)
    G = H // Kv
    i = torch.arange(S)
    ok = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 7)
    for h in range(H):
        s = torch.einsum("bqd,bkd->bqk", tq[:, :, h], tk[:, :, h // G]) / 4.0
        want = torch.logsumexp(torch.where(ok, s, -1e30), dim=-1)
        torch.testing.assert_close(lse[:, h], want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_bwd_matches_torch_autograd_of_plain(shape, causal, window):
    """The chunked backward against torch's autograd through the plain
    attention (materialised softmax), fp32."""
    (_, tq), (_, tk), (_, tv), (_, tdo) = _inputs(*shape, "float32", 21)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ref.flash_attention(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(out, leaves, tdo)
    out, lse = ref.flash_attention(tq, tk, tv, causal=causal, window=window,
                                   with_lse=True)
    got = ref.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal=causal,
                                  window=window, chunk=48)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL["float32"],
                                   atol=TOL["float32"])


def test_flash_function_is_the_plain_math_on_the_cpu(monkeypatch):
    """``ops.attention`` with a gradient wanted goes through
    ``FlashAttention``: its gradients are ``ref.flash_attention_bwd``'s
    over kv chunks of ``ops.KV_CHUNK``, bit for bit; without one it returns
    the plain forward, no graph."""
    (_, tq), (_, tk), (_, tv), (_, tdo) = _inputs(1, 50, 4, 2, 32,
                                                  "float32", 4)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    monkeypatch.setattr(ops, "KV_CHUNK", 16)
    out = ops.attention(*leaves, causal=True, window=0)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, tdo)
    o, lse = ref.flash_attention(tq, tk, tv, with_lse=True)
    want = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        plain = ops.attention(*leaves, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, o)
    assert torch.equal(out.detach(), o)


def test_rmsnorm_function_on_the_cpu():
    x = torch.randn(3, 5, 32, requires_grad=True)
    s = (1 + 0.1 * torch.randn(32)).requires_grad_()
    y = ops.rms_norm(x, s, 1e-6)
    assert "RMSNorm" in type(y.grad_fn).__name__
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, s), dy)
    assert all(torch.equal(g, w) for g, w in zip(
        got, ref.rmsnorm_bwd(x.detach(), s.detach(), dy, 1e-6)))
    with torch.no_grad():
        assert ops.rms_norm(x, s).grad_fn is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (2, 17, 256), (1, 3, 5, 128)])
def test_rmsnorm_grad_matches_jax(shape, dtype):
    """``RMSNorm``'s dx and dscale against ``jax.grad`` of
    ``apply_norm("rmsnorm")`` (the JAX package has no custom VJP: autodiff
    of the fp32 formula, cast to x's and scale's dtypes)."""
    rng = np.random.RandomState(len(shape) + shape[-1])
    (jx, tx), (js, ts), (jdy, tdy) = (
        _both(a, dtype) for a in (rng.randn(*shape).astype(np.float32),
                                  (1 + 0.1 * rng.randn(shape[-1]))
                                  .astype(np.float32),
                                  rng.randn(*shape).astype(np.float32)))
    y, vjp = jax.vjp(lambda x, s: JL.apply_norm("rmsnorm", {"scale": s}, x),
                     jx, js)
    jdx, jds = vjp(jdy)
    x, s = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    out = ops.RMSNorm.apply(x, s, 1e-6)
    _close(out.detach(), y, TOL[dtype], "y")
    dx, ds = torch.autograd.grad(out, (x, s), tdy)
    assert dx.dtype == ds.dtype == TDT[dtype]
    _close(dx, jdx, TOL[dtype], "dx")
    _close(ds, jds, TOL[dtype], "dscale")


def test_flash_wrapper_with_lse_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        FA.flash_attention(q, q, q, with_lse=True)


@pytest.mark.parametrize("remat,per_layer", [(True, 2), (False, 1)])
def test_remat_runs_each_layers_flash_forward_twice(monkeypatch, remat,
                                                    per_layer):
    """Under remat every layer's ``FlashAttention`` forward runs again in
    the backward (the card's launch count: layers x microbatches x 2, 192
    without remat at stablelm-1.6b's 24 layers and 8 microbatches), and
    every such call writes lse; prefill under ``no_grad`` writes none."""
    calls = []
    plain = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append(kw.get("with_lse", False))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    cfg = C.get_smoke("qwen1.5-110b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import steps as TST
    from repro_torch.optim import optimizers as TO
    from repro_torch.launch.mesh import make_host_mesh
    bound = TST.bind_train(make_host_mesh("cpu"), cfg, Runtime(remat=remat),
                           TO.sgd(0.1),
                           InputShape("t", 8, 4, "train"),
                           num_microbatches=2)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (4, 9)).astype(np.int32))
    bound["grads"](params, {"tokens": toks})
    assert calls == [True] * (cfg.n_layers * 2 * per_layer)
    calls.clear()
    with torch.no_grad():
        TM.prefill(params, cfg, Runtime(), {"tokens": toks[:, :8]},
                   TM.init_cache(cfg, 4, 12))
    assert calls == [False] * cfg.n_layers
