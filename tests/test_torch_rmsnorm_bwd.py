"""RMSNorm's backward in the port, on the CPU: the dispatch, the autograd
``Function`` calling it by name, the kernel wrapper's refusals, and a CPU
model of the kernel's arithmetic order against the JAX package.

The kernel (``kernels/csrc/rmsnorm.cu``, ``rmsnorm_bwd_*``) runs only on the
card, where ``chip_smoke.py`` holds it against ``ref.rmsnorm_bwd``. Here
``_kernel_model`` does its sums in its order: per row, r = 1 / sqrt(sum(x^2)
/ D + eps) and c = r^3 * sum(dy * scale * x) / D, dx = r * scale * dy - x
* c, in fp32; dscale as the rows launch and the cols launch add it: block b
of G = min(rows, ``BWD_BLOCKS``) adds dy * (x * r) over its rows b, b + G,
... in order into fp32 column sums; then warp w of the cols launch adds the
blocks w, w + 8, ... in order, and the 8 warps' sums are added in warp
order. The model is held against ``jax.grad`` of
``repro/models/layers.py::apply_norm`` (the JAX package has no custom VJP)
at ``tests/test_kernels.py::_tol``: 2e-5 (fp32) and 2e-2 (bf16) of max
|grad|, at the JAX sweep's shapes and at row counts past ``BWD_BLOCKS`` (so
blocks take several rows and the cols launch adds every warp's share).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as RN

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
WARPS = 8             # the cols launch's warps (rmsnorm.cu: kThreads / 32)


def _kernel_model(x, scale, dy, eps=1e-6, blocks_max=RN.BWD_BLOCKS):
    """(dx in x's dtype, dscale in scale's dtype), summed in the kernel's
    order (module docstring)."""
    D = x.shape[-1]
    xf = x.reshape(-1, D).float()
    gf = dy.reshape(-1, D).float()
    sf = scale.float()
    rows = xf.shape[0]
    r = 1.0 / torch.sqrt(torch.sum(xf * xf, -1, keepdim=True) / D + eps)
    c = r * r * r * (torch.sum(gf * sf * xf, -1, keepdim=True) / D)
    dx = r * sf * gf - xf * c
    contrib = gf * (xf * r)
    G = min(rows, blocks_max)
    part = torch.zeros(G, D)
    for j in range(-(-rows // G)):           # each block's j-th row, in order
        ids = torch.arange(G) + j * G
        ok = ids < rows
        part[ok] += contrib[ids[ok]]
    warp = torch.zeros(WARPS, D)
    for b in range(G):                       # warp b % 8 adds block b
        warp[b % WARPS] += part[b]
    dscale = torch.zeros(D)
    for w in range(WARPS):
        dscale += warp[w]
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(*shape).astype(np.float32),
              (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32),
              rng.randn(*shape).astype(np.float32))
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrays])


def _close(got, want, tol, what):
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of max |grad| (tol {tol})"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (2, 17, 256), (1, 3, 5, 128),
                                   (3, 129), (2, 130), (600, 64),
                                   (2, 265, 96)])
def test_kernel_model_matches_jax_grad(shape, dtype):
    (jx, js, jdy), (x, s, dy) = _inputs(shape, dtype, seed=shape[-1])
    _, vjp = jax.vjp(lambda x, s: JL.apply_norm("rmsnorm", {"scale": s}, x),
                     jx, js)
    jdx, jds = vjp(jdy)
    dx, ds = _kernel_model(x, s, dy)
    assert dx.dtype == ds.dtype == TDT[dtype]
    _close(dx, jdx, TOL[dtype], "dx")
    _close(ds, jds, TOL[dtype], "dscale")


def test_kernel_model_takes_several_rows_a_block():
    """Past ``BWD_BLOCKS`` rows each block walks a strip: the model's
    partials then differ from one sum over all rows only in the order, and
    one block's strip is every G-th row."""
    (_, _, _), (x, s, dy) = _inputs((RN.BWD_BLOCKS * 2 + 5, 32), "float32",
                                    seed=3)
    _, ds = _kernel_model(x, s, dy)
    _, want = ref.rmsnorm_bwd(x, s, dy)
    torch.testing.assert_close(ds, want, rtol=1e-5, atol=1e-5)
    assert RN.BWD_LAUNCHES == 2


def test_ops_rmsnorm_bwd_is_the_plain_version_on_the_cpu():
    (_, _, _), (x, s, dy) = _inputs((3, 5, 64), "float32", seed=1)
    before = RN.rmsnorm_bwd.launches
    got = ops.rmsnorm_bwd(x, s, dy, 1e-6)
    want = ref.rmsnorm_bwd(x, s, dy, 1e-6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert RN.rmsnorm_bwd.launches == before


def test_rmsnorm_function_calls_the_backward_by_name(monkeypatch):
    """``RMSNorm.backward`` looks ``ops.rmsnorm_bwd`` up at call time, so a
    comparison that patches the name (``chip_smoke.py::plain_kernels``)
    changes what the backward runs."""
    calls = []

    def marked(x, scale, dy, eps):
        calls.append((tuple(x.shape), eps))
        return torch.full_like(x, 2.0), torch.full_like(scale, 3.0)

    monkeypatch.setattr(ops, "rmsnorm_bwd", marked)
    x = torch.randn(2, 3, 16, requires_grad=True)
    s = torch.ones(16, requires_grad=True)
    y = ops.rms_norm(x, s, 1e-5)
    dx, ds = torch.autograd.grad(y, (x, s), torch.randn_like(y))
    assert calls == [((2, 3, 16), 1e-5)]
    assert torch.equal(dx, torch.full_like(x, 2.0))
    assert torch.equal(ds, torch.full_like(s, 3.0))


@pytest.mark.parametrize("bad,why", [("cpu", "not a CUDA device"),
                                     ("dy_dtype", "dy is torch.bfloat16"),
                                     ("dy_shape", "dy has shape"),
                                     ("dy_strided", "dy must be contiguous"),
                                     ("scale_shape", "scale has shape"),
                                     ("float64", "not supported")])
def test_rmsnorm_bwd_wrapper_raises(bad, why):
    x, s, dy = torch.ones(4, 8), torch.ones(8), torch.ones(4, 8)
    if bad == "dy_dtype":
        dy = dy.bfloat16()
    elif bad == "dy_shape":
        dy = torch.ones(8, 4)
    elif bad == "dy_strided":
        dy = torch.ones(8, 4).t()
    elif bad == "scale_shape":
        s = torch.ones(4)
    elif bad == "float64":
        x, s, dy = x.double(), s.double(), dy.double()
    before = RN.rmsnorm_bwd.launches
    with pytest.raises(ValueError, match=why):
        RN.rmsnorm_bwd(x, s, dy)
    assert RN.rmsnorm_bwd.launches == before


def test_backward_source_declares_the_bound_functions():
    src = RN.SOURCE.read_text()
    for rows_name, cols_name in RN._BWD_FNS.values():
        assert f"int {rows_name}(" in src and f"int {cols_name}(" in src
