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

Since the redesign the route runs other rows kernels (the first ones stay
as its yardstick); ``_route_model`` does their sums in their order, at the
tier and grid G the C launcher picks (``_plan``, which reads the
launcher's branches from the source): every operation rounded as the kernels'
explicit intrinsics round it (``__fmaf_rn`` as one rounding); each
thread's pieces in order as fma chains, then a butterfly of xor shuffles
over the warp (the warp tier: a warp a row) or that and the 8 warps'
sums in order (the block tier); dscale's column terms as fma chains over
each warp's (warp tier: rows b * 8 + w + k * 8G) or block's (block tier:
rows b + kG) rows, the warp tier's 8 warps added in order into part[b],
then the yardstick's cols launch. It is held against ``jax.grad`` at the
same tolerances, at shapes where a warp or a block walks more than one row,
and shown to differ from ``_kernel_model``'s order; the launcher's
branches are held to the tiers and grids they were chosen as.

``chip_smoke.py::rms_bwd_gate``, the rule that times the kernel against
its yardstick on the card, is held here to the readings of two runs of an
unchanged tree on the H100: it passes both (the first failed the former
rule, the kernel's event median against the yardstick's fastest turn),
and it fails a kernel whose median is the slower one.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib
import re
import statistics

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


def _fma(a, x, y):
    """fp32 a + x * y with one rounding of the product and the sum
    (computed in fp64, where the product of two fp32 values is exact)."""
    return (a.double() + x.double() * y.double()).float()


def _butterfly(v):
    """The xor-shuffle butterfly over the last dim's 32 lanes (every lane
    ends with the same bits): lane 0's total."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ o]
    return v[..., 0]


def _thread_sums(xf, gf, sf, threads, nv, vec):
    """Each thread's two row sums [rows, threads]: its pieces t + threads *
    k (k < nv) of ``vec`` elements, in order, as fma chains (sum x^2 and
    sum (dy * scale) * x)."""
    rows, D = xf.shape
    ss = torch.zeros(rows, threads)
    dot = torch.zeros(rows, threads)
    for k in range(nv):
        piece = torch.arange(threads) + threads * k
        ok = piece < D // vec
        for j in range(vec):
            col = (piece * vec + j).clamp(max=D - 1)
            xv = torch.where(ok, xf[:, col], 0.0)
            gs = torch.where(ok, gf[:, col] * sf[col], 0.0)
            ss, dot = _fma(ss, xv, xv), _fma(dot, gs, xv)
    return ss, dot


def _in_order(parts):
    """parts[0] + parts[1] + ... in fp32, left to right."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _launcher():
    """The source's integer constants and the route launcher's rows
    branches, in order: (the most pieces, tier, pieces a thread, rows a
    walker, grid), read from ``launch_bwd``."""
    src = RN.SOURCE.read_text()
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    consts["kWarps"] = consts["kThreads"] // 32

    def value(expr):
        n = 1
        for factor in expr.split("*"):
            factor = factor.strip()
            n *= int(factor) if factor.isdigit() else consts[factor]
        return n

    body = src[src.index("int launch_bwd(const void* x"):]
    body = body[:body.index("#undef RMS_BWD_NEW")]
    return consts, [
        (value(most), tier, int(nv), value(walk), int(grid))
        for most, tier, nv, walk, grid in re.findall(
            r"vec && nvec <= ([\w *]+)\)\s*RMS_BWD_NEW\(rmsnorm_bwd_(\w+)"
            r"_kernel, (\d), (\w+), (\d+)\);", body)]


CONSTS, BRANCHES = _launcher()


def _plan(rows, D, dtype, vec):
    """The route's rows launch as ``launch_bwd`` picks it for ``rows`` rows
    of D: (tier, pieces a thread, blocks G); ``vec``: every row 16-byte
    aligned. The first branch that takes the row's 16-byte pieces gives the
    tier, G its walkers up to the branch's grid; else ``yardstick`` (the
    first kernels' rows launch, G = min(rows, kBwdBlocks))."""
    pieces = D // RN._VEC[dtype]
    for most, tier, nv, walk, grid in BRANCHES:
        if vec and pieces <= most:
            return tier, nv, min(-(-rows // walk), grid)
    return "yardstick", None, min(rows, CONSTS["kBwdBlocks"])


def _route_model(x, scale, dy, eps=1e-6):
    """(dx in x's dtype, dscale in scale's dtype) summed in the route's
    order at the launcher's tier and grid (``_plan``; module docstring);
    rows of 16-byte pieces, as fresh tensors are."""
    D = x.shape[-1]
    xf = x.reshape(-1, D).float()
    gf = dy.reshape(-1, D).float()
    sf = scale.float()
    rows = xf.shape[0]
    vec = RN._VEC[x.dtype]
    tier, nv, G = _plan(rows, D, x.dtype, D % vec == 0)
    if tier == "yardstick":
        return _kernel_model(x, scale, dy, eps)
    ss, dot = _thread_sums(xf, gf, sf, 32 if tier == "warp" else 256, nv,
                           vec)
    if tier == "warp":
        ss, dot = _butterfly(ss), _butterfly(dot)
    else:
        ss = _in_order(_butterfly(ss.reshape(rows, WARPS, 32)).unbind(-1))
        dot = _in_order(_butterfly(dot.reshape(rows, WARPS, 32)).unbind(-1))
    inv_d = torch.tensor(1.0) / D
    r = torch.ones(rows) / torch.sqrt(_fma(torch.tensor(eps), ss, inv_d))
    c = ((r * r) * r) * (dot * inv_d)
    dx = (r[:, None] * sf) * gf - xf * c[:, None]
    xr = xf * r[:, None]
    # dscale's column terms, fma chains over each walker's rows in order:
    # a warp's (rows b * 8 + w + k * 8G) or a block's (rows b + k * G)
    walkers = G * WARPS if tier == "warp" else G
    steps = -(-rows // walkers)
    pad = steps * walkers - rows
    gk = torch.cat([gf, torch.zeros(pad, D)]).reshape(steps, walkers, D)
    xk = torch.cat([xr, torch.zeros(pad, D)]).reshape(steps, walkers, D)
    acc = torch.zeros(walkers, D)
    for k in range(steps):
        acc = _fma(acc, gk[k], xk[k])
    if tier == "warp":               # the block's 8 warps, in warp order
        acc = _in_order(acc.reshape(G, WARPS, D).unbind(1))
    # the cols launch: warp w adds blocks w, w + 8, ... from 0, then the
    # warps' sums in order
    warp = [torch.zeros(D) for _ in range(WARPS)]
    for b in range(G):
        warp[b % WARPS] = warp[b % WARPS] + acc[b]
    dscale = _in_order(warp)
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


# the JAX sweep's shapes, then rows past one walk of each tier: the warp
# tier at 1, 2 and 4 pieces a lane (with more rows than 8 * G, so a warp
# takes several), the block tier at 1, 2 and 4 pieces a thread (more rows
# than G)
ROUTE_SHAPES = [(4, 64), (2, 17, 256), (1, 3, 5, 128), (3, 129), (2, 130),
                (600, 64), (2, 265, 96), (4300, 128), (2200, 512),
                (1100, 1024), (800, 2048), (280, 4096), (140, 8192)]


@pytest.fixture(scope="module")
def jax_grads():
    """jax.vjp of ``apply_norm`` at each (shape, dtype) of ROUTE_SHAPES,
    with the torch inputs, computed once for the module."""
    out = {}
    for shape in ROUTE_SHAPES:
        for dtype in ("float32", "bfloat16"):
            (jx, js, jdy), ts = _inputs(shape, dtype, seed=shape[-1] + 1)
            _, vjp = jax.vjp(lambda x, s: JL.apply_norm(
                "rmsnorm", {"scale": s}, x), jx, js)
            out[shape, dtype] = (ts, vjp(jdy))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES, ids=str)
def test_route_model_matches_jax_grad(jax_grads, shape, dtype):
    (x, s, dy), (jdx, jds) = jax_grads[shape, dtype]
    dx, ds = _route_model(x, s, dy)
    assert dx.dtype == ds.dtype == TDT[dtype]
    _close(dx, jdx, TOL[dtype], "dx")
    _close(ds, jds, TOL[dtype], "dscale")


@pytest.mark.parametrize("shape", [(2200, 512), (800, 2048)], ids=str)
def test_route_model_is_not_the_yardstick_order(jax_grads, shape):
    """At a warp-tier and a block-tier shape the route's order gives other
    bits than the yardstick's (``_kernel_model``) in fp32, within the fp32
    tolerance of each other: the agreement above is of the route's order."""
    (x, s, dy), _ = jax_grads[shape, "float32"]
    got, old = _route_model(x, s, dy), _kernel_model(x, s, dy)
    assert not torch.equal(got[1], old[1])
    for a, b in zip(got, old):
        torch.testing.assert_close(a, b, rtol=TOL["float32"],
                                   atol=TOL["float32"] * b.abs().max().item())


def test_launchers_tiers_and_grids():
    """The C launcher's rows branches (read from the source) are the tiers
    and grids chosen on the card, every grid within the partials the
    wrapper holds; at every row width of 16-byte pieces up to past the
    block tier, in both dtypes, the launcher takes the warp tier up to
    kBwdWarpPieces, the block tier up to kBwdBlockPieces, else the
    yardstick's rows kernels, with 1 <= G <= the rows its walkers take;
    unaligned rows take the yardstick's."""
    assert CONSTS["kBwdWarpPieces"] == 128
    assert CONSTS["kBwdBlockPieces"] == 1024
    assert BRANCHES == [(32, "warp", 1, 8, 264), (64, "warp", 2, 8, 264),
                        (128, "warp", 4, 8, 132), (256, "block", 1, 1, 396),
                        (512, "block", 2, 1, 264), (1024, "block", 4, 1, 132)]
    assert CONSTS["kBwdBlocks"] == RN.BWD_BLOCKS
    assert CONSTS["kBwdPartRows"] == RN.BWD_PART_ROWS == max(
        RN.BWD_BLOCKS, *(grid for *_, grid in BRANCHES))
    for dtype, vec in RN._VEC.items():
        for pieces in range(1, 1100):
            for rows in (1, 9, 4096):
                tier, nv, G = _plan(rows, pieces * vec, dtype, True)
                want = "warp" if pieces <= CONSTS["kBwdWarpPieces"] else \
                    "block" if pieces <= CONSTS["kBwdBlockPieces"] else \
                    "yardstick"
                assert tier == want
                cap = -(-rows // 8) if tier == "warp" else rows
                assert 1 <= G <= min(cap, RN.BWD_PART_ROWS)
        assert _plan(4096, 129, dtype, False) == \
            ("yardstick", None, RN.BWD_BLOCKS)
        assert _plan(4096, 896, dtype, False)[0] == "yardstick"
    assert _plan(4096, 896, torch.bfloat16, True) == ("warp", 4, 132)


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
    for name in RN._BWD_FNS.values():
        assert f"int {name}(" in src
    for rows_name, cols_name in RN._YARDSTICK_BWD_FNS.values():
        assert f"int {rows_name}(" in src and f"int {cols_name}(" in src


def test_rmsnorm_bwd_yardstick_refuses_cpu_tensors():
    x, s, dy = torch.ones(4, 8), torch.ones(8), torch.ones(4, 8)
    before = RN.rmsnorm_bwd.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        RN.rmsnorm_bwd_yardstick(x, s, dy)
    assert RN.rmsnorm_bwd.launches == before
    assert RN.build_bwd_yardstick.cache_info().currsize == 0


@functools.cache
def _chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only; its phases run on the card alone)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# two runs on an unchanged tree (H100 80GB HBM3, 700.00 W) at [4096, 896]
# bf16: wrapper-timed event turns (ms) of kernel and yardstick, and the
# medians of the device windows. r1's turns are all recorded; of r2's, the
# kernel's median and the yardstick's fastest and slowest turns
GATE_READINGS = {
    "r1": (dict(kernel=[0.05909, 0.05669, 0.05933, 0.05459, 0.05667,
                        0.04436],
                yardstick=[0.08571, 0.08248, 0.08947, 0.07898, 0.08626,
                           0.04865]), 0.00873, 0.01443),
    "r2": (dict(kernel=[0.04291], yardstick=[0.06140, 0.06253]),
           0.00887, 0.01465),
}


@pytest.mark.parametrize("run", sorted(GATE_READINGS))
def test_timing_gate_passes_the_unchanged_tree(run):
    cs = _chip_smoke()
    turns, dev, yard_dev = GATE_READINGS[run]
    assert cs.rms_bwd_gate(cs.RMS_BWD_FASTER_AT, turns, dev, yard_dev)
    # the former rule: the kernel's median below the yardstick's fastest
    # turn, which r1's one fast yardstick turn failed
    former = statistics.median(turns["kernel"]) < min(turns["yardstick"])
    assert former == (run == "r2")


def test_timing_gate_fails_a_slower_kernel():
    cs = _chip_smoke()
    turns, dev, yard_dev = GATE_READINGS["r1"]
    swapped = dict(kernel=turns["yardstick"], yardstick=turns["kernel"])
    shape = cs.RMS_BWD_FASTER_AT
    assert not cs.rms_bwd_gate(shape, swapped, dev, yard_dev)
    assert not cs.rms_bwd_gate(shape, turns, yard_dev, dev)
    assert not cs.rms_bwd_gate(shape, turns, None, yard_dev)
    # the other rows: by device time alone, no slower
    assert cs.rms_bwd_gate((4096, 8192), swapped, dev, dev)
    assert not cs.rms_bwd_gate((4096, 8192), turns, yard_dev, dev)
