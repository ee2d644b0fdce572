"""The port's rmsnorm and flash_attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX runs
at ``highest`` matmul precision (``tests/conftest.py``). The plain versions
are held to the JAX oracles (``repro/kernels/ref.py``) over the sweeps of
``tests/test_kernels.py``, and to the Pallas kernels in interpret mode on a
few cases (the JAX package's own tests hold Pallas against its oracles over
the whole sweep). The CUDA kernels run only on the card (``chip_smoke.py``);
here the dispatch sends CPU tensors to the plain versions and the wrappers
refuse what their kernels do not take. A model of the bf16 tensor-core
kernel's rounding (``_tc_model``) is held to the JAX oracle at the
tolerances ``chip_smoke.py`` holds the kernel to on the card.
"""
from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import configs as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as RN

# tests/test_kernels.py::_tol — fp32 2e-5; bf16 2e-2 (8 mantissa bits)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# tests/test_kernels.py::test_flash_attention_sweep (fp32)
FLASH_RTOL, FLASH_ATOL = 5e-5, 5e-6
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}

RMS_SHAPES = [(4, 64), (2, 17, 256), (1, 3, 5, 128)]
FLASH_SHAPES = [(1, 64, 4, 4, 32),      # MHA
                (2, 129, 8, 4, 64),     # GQA, ragged seq
                (1, 200, 8, 1, 16)]     # MQA
MASKS = [(True, 0), (True, 37), (False, 0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread is as fast, and it leaves the other
    cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(a: np.ndarray, dtype: str):
    """One fp32 numpy array as (jax array, torch tensor) of ``dtype``; a
    bf16 value is rounded once, by JAX, and carried bit for bit."""
    j = jnp.asarray(a).astype(DTYPES[dtype][1])
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(DTYPES[dtype][2])


def _close(got: torch.Tensor, want, rtol, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_jax_oracle(shape, dtype):
    rng = np.random.RandomState(len(shape))
    jx, tx = _both(rng.randn(*shape).astype(np.float32), dtype)
    js, ts = _both(rng.randn(shape[-1]).astype(np.float32), dtype)
    got = ref.rmsnorm(tx, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jref.rmsnorm(jx, js), TOL[dtype], TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [((2, 17, 256), "float32"),
                                         ((4, 64), "bfloat16")])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.RandomState(5)
    jx, tx = _both(rng.randn(*shape).astype(np.float32), dtype)
    js, ts = _both(rng.randn(shape[-1]).astype(np.float32), dtype)
    _close(ref.rmsnorm(tx, ts), jops.rmsnorm(jx, js, interpret=True),
           TOL[dtype], TOL[dtype])


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _qkv(B, S, H, Kv, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    return [_both((rng.randn(B, S, n, hd) * 0.5).astype(np.float32), dtype)
            for n in (H, Kv, Kv)]


@pytest.mark.parametrize("B,S,H,Kv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_plain_matches_jax_oracle(B, S, H, Kv, hd, causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, Kv, hd, "float32", S + H)
    got = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = jref.flash_attention(jq, jk, jv, causal=causal, window=window)
    _close(got, want, FLASH_RTOL, FLASH_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dtype_matches_jax_oracle(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 64, 4, 2, 32, dtype, 7)
    got = ref.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype
    _close(got, jref.flash_attention(jq, jk, jv), TOL[dtype], TOL[dtype])


@pytest.mark.parametrize("B,S,H,Kv,hd,causal,window", [
    (2, 129, 8, 4, 64, True, 37),       # GQA, ragged, sliding window
    (1, 64, 4, 4, 32, False, 0)])       # MHA, no mask
def test_flash_plain_matches_pallas(B, S, H, Kv, hd, causal, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, Kv, hd, "float32", 11)
    got = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                blk_q=64, blk_k=64, interpret=True)
    _close(got, want, FLASH_RTOL, FLASH_ATOL)


def test_flash_gqa_head_order():
    """Query head h reads kv head h // G (the JAX reshape(B,S,Kv,G,hd)),
    not h % Kv: a per-head loop built on that rule agrees, the other rule
    does not."""
    B, S, H, Kv, hd = 1, 12, 8, 2, 16
    G = H // Kv
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32))
               for n in (H, Kv, Kv))
    got = ref.flash_attention(q, k, v, causal=True)
    mask = torch.ones(S, S, dtype=torch.bool).tril()

    def per_head(kv_of):
        outs = []
        for h in range(H):
            s = q[:, :, h] @ k[:, :, kv_of(h)].transpose(1, 2) / math.sqrt(hd)
            p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
            outs.append(p @ v[:, :, kv_of(h)])
        return torch.stack(outs, dim=2)

    torch.testing.assert_close(got, per_head(lambda h: h // G), rtol=1e-5,
                               atol=1e-6)
    assert not torch.allclose(got, per_head(lambda h: h % Kv), atol=1e-3)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's arithmetic (csrc/flash_attention.cu,
# flash_kernel_wgmma), modelled on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.py's gates at qwen's prefill shape in bf16: rtol of _tol, atol
# QWEN_FLASH_BF16_ATOL
QWEN_RTOL, QWEN_ATOL = 2e-2, 5e-4
TC_KV_TILE = 64        # kv positions a tile of flash_kernel_wgmma (hd < 256)


def _tc_plan(hd):
    """The tensor-core kernels' choices at a (padded) bf16 width, as
    csrc/flash_attention.cu makes them: (kv tile, hd chunk the scores are
    summed over, output columns a block owns). Up to 256 the kernels take
    hd whole: flash_kernel_wgmma in kv tiles of 32 at 256, else 64, and at
    64, 128 and 192 flash_kernel_wgmma_pipe in kv tiles of 64 with the same
    order of sums (S over hd in one chain, then a tile's P_hi V and P_lo V
    added to the rescaled accumulator); its pipeline only moves a tile's
    softmax under the previous tile's P.V, and its q tiles' rows (whole
    positions; two or three warpgroups, tests/test_torch_flash_fwd_pipe.py)
    move where a kv tile is scaled before or after its max, which this
    model leaves out (last bits). Above 256 the column-block kernel sums S
    over 64-column chunks, in kv tiles of 64, and owns 128 output columns
    a block."""
    if hd <= 256:
        return (32 if hd == 256 else TC_KV_TILE), None, hd
    return TC_KV_TILE, 64, 128


def _tc_model(q, k, v, *, causal=True, window=0, split_p=True, scale=None,
              kv_tile=TC_KV_TILE, s_chunk=None, col_block=None):
    """What the tensor-core kernels compute, in their rounding: q and k raw
    bf16, fp32 dot products (summed over hd in chunks of ``s_chunk``
    columns where given, as the column-block kernel accumulates them)
    scaled after the product into the log2 domain (p = 2^(s * c - m),
    masked scores -1e30), the online softmax tile by tile over kv tiles of
    ``kv_tile`` positions, P in bf16 before P.V (when ``split_p``, as the
    kernels do, hi = p truncated to bf16 and lo = p - hi rounded to bf16,
    both through P.V; otherwise p rounded once to bf16), fp32 accumulation
    (P.V by blocks of ``col_block`` output columns, each block's S the
    same), one rounding of the output to q's dtype. ``scale`` is the
    wrapper's 1/sqrt(hd) of the unpadded width (default: q's width). Tiles
    the kernels skip are fully masked for all of a block's rows and change
    nothing here."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    col_block = col_block or hd
    qf = q.float().reshape(B, S, Kv, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, Kv, S * G, hd)                       # folded rows
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    c = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    qpos = (torch.arange(S * G) // G)[:, None]
    m = torch.full((B, Kv, S * G, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Kv, S * G, hd)
    for k0 in range(0, S, kv_tile):
        kt, vt = kf[:, :, k0:k0 + kv_tile], vf[:, :, k0:k0 + kv_tile]
        if s_chunk is None:
            s = qf @ kt.transpose(-1, -2)
        else:
            s = sum(qf[..., d:d + s_chunk] @
                    kt[..., d:d + s_chunk].transpose(-1, -2)
                    for d in range(0, hd, s_chunk))
        s = s * c
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones(S * G, kt.shape[2], dtype=torch.bool)
        if causal:
            ok &= kp <= qpos
        if window:
            ok &= kp > qpos - window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if split_p:
            hi = (p.view(torch.int32) & -65536).view(torch.float32)
            parts = (hi, (p - hi).bfloat16().float())
        else:
            parts = (p.bfloat16().float(),)
        pv = torch.cat([sum(a @ vt[..., c0:c0 + col_block] for a in parts)
                        for c0 in range(0, hd, col_block)], dim=-1)
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, Kv, S, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, H, hd).to(q.dtype)


def _fwd_padded(attend, q, k, v, causal, window):
    """The forward wrapper's padding, ``FA._pad_call`` to
    ``native_head_dim``, around ``attend(q, k, v, causal, window, scale)``."""
    return FA._pad_call(attend, (q, k, v),
                        FA.native_head_dim(q.shape[-1], q.dtype), causal,
                        window)


def _tc_wrapped(q, k, v, *, causal=True, window=0, split_p=True):
    """``_tc_model`` on the wrapper's path (``FA._pad_call``: bf16 zero-padded
    to the kernel's width, the true scale passed, the output cut back),
    with the kernel's choices at that width (``_tc_plan``)."""
    def attend(q, k, v, causal, window, scale):
        kv_tile, s_chunk, col_block = _tc_plan(q.shape[-1])
        return _tc_model(q, k, v, causal=causal, window=window,
                         split_p=split_p, scale=scale, kv_tile=kv_tile,
                         s_chunk=s_chunk, col_block=col_block)
    return _fwd_padded(attend, q, k, v, causal, window)


def _gate_excess(got, want, rtol):
    """max(|got - want| - rtol * |want|): allclose at (rtol, atol) holds
    iff this is at most atol."""
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.float().numpy() - w) - rtol * np.abs(w)))


@pytest.mark.parametrize("B,S,H,Kv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("at_128", [False, True], ids=["hd", "hd128"])
def test_flash_tc_model_matches_jax_oracle_bf16(B, S, H, Kv, hd, causal,
                                                 window, at_128):
    """The sweep in bf16, at its own head dim and at qwen's 128, within
    _tol's 2e-2."""
    hd = 128 if at_128 else hd
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, Kv, hd, "bfloat16", S + H)
    got = _tc_model(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    _close(got, jref.flash_attention(jq, jk, jv, causal=causal,
                                     window=window), TOL["bfloat16"],
           TOL["bfloat16"])


def _qwen_cut(Kv, scale, seed):
    """qwen1.5-110b's prefill attention cut in width: S = 1,024, G = 8,
    hd = 128, Kv kv heads, inputs N(0, 1) x scale, bf16."""
    rng = np.random.RandomState(seed)
    return [_both((rng.randn(1, 1024, n, 128) * scale).astype(np.float32),
                  "bfloat16") for n in (8 * Kv, Kv, Kv)]


@pytest.mark.parametrize("Kv", [1, 2])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_flash_tc_model_meets_qwen_gate(Kv, scale):
    """At a qwen-like shape, x0.5 (near-uniform softmax) and x2 (peaked),
    the modelled kernel meets chip_smoke.py's bf16 gate against the JAX
    oracle: rtol 2e-2, atol 5e-4."""
    (jq, tq), (jk, tk), (jv, tv) = _qwen_cut(Kv, scale, seed=Kv)
    want = jref.flash_attention(jq, jk, jv)
    assert _gate_excess(_tc_model(tq, tk, tv), want, QWEN_RTOL) <= QWEN_ATOL


def test_flash_tc_model_single_bf16_p_misses_qwen_gate():
    """Why the kernel splits P into bf16 hi + lo (2^-16 relative): P
    rounded once to bf16 (2^-9 relative on each p) misses the same gate at
    the same inputs."""
    (jq, tq), (jk, tk), (jv, tv) = _qwen_cut(1, 2.0, seed=1)
    want = jref.flash_attention(jq, jk, jv)
    assert _gate_excess(_tc_model(tq, tk, tv, split_p=False), want,
                        QWEN_RTOL) > QWEN_ATOL


def test_tc_plan_is_the_kernels():
    """The widths the kernels' choices are modelled at: 33-64, 65-128 and
    129-192 padded to 64, 128 and 192, taken whole in kv tiles of 64
    (flash_kernel_wgmma_pipe); hd 256 whole in kv tiles of 32; above 256
    (padded to a multiple of 64) S summed over 64-column chunks and 128
    output columns a block, so 576 takes 5 blocks (the last one cut at
    576) and 1,024 takes 8."""
    assert _tc_plan(64) == (64, None, 64)
    assert _tc_plan(128) == (64, None, 128)
    assert _tc_plan(192) == (64, None, 192)
    for lo, wide in ((33, 64), (65, 128), (129, 192)):
        assert all(FA.native_head_dim(hd, torch.bfloat16) == wide
                   for hd in range(lo, wide + 1))
    assert _tc_plan(256) == (32, None, 256)
    assert _tc_plan(576) == _tc_plan(1024) == (64, 64, 128)
    for hd in range(257, 2049, 7):
        wide = FA.native_head_dim(hd, torch.bfloat16)
        assert wide % 64 == 0 and wide - 64 < hd <= wide
        assert _tc_plan(wide)[1:] == (64, 128)


@pytest.mark.parametrize("hd", [192, 129, 160, 191])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_tc_hd192_model_matches_jax_oracle_bf16(hd, causal, window):
    """flash_kernel_wgmma_pipe's arithmetic at 192 and, through the
    wrapper's zero-padding to 192 with the true scale, at 129, 160 and 191,
    at nemotron-4-340b's 12 query heads a kv head (a q tile of 120 folded
    rows, 10 whole positions) against the JAX oracle in bf16 within _tol's
    2e-2."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 72, 24, 2, hd, "bfloat16", hd)
    got = _tc_wrapped(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, jref.flash_attention(jq, jk, jv, causal=causal,
                                     window=window), TOL["bfloat16"],
           TOL["bfloat16"])


@pytest.mark.parametrize("hd", [200, 256, 576, 1024])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_tc_wide_model_matches_jax_oracle_bf16(hd, causal, window):
    """The wide tensor-core routes' arithmetic on the wrapper's path (200
    padded to 256, kv tiles of 32; 576 and 1,024 in column blocks of 128,
    S summed over 64-column chunks) against the JAX oracle in bf16 within
    _tol's 2e-2."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 72, 4, 2, hd, "bfloat16", hd)
    got = _tc_wrapped(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, jref.flash_attention(jq, jk, jv, causal=causal,
                                     window=window), TOL["bfloat16"],
           TOL["bfloat16"])


@functools.lru_cache(maxsize=None)
def _qwen_cut_hd(hd, scale):
    """qwen1.5-110b's prefill attention cut in width, at head width hd:
    S = 1,024, G = 8, one kv head, inputs N(0, 1) x scale, bf16 (seed hd);
    the torch q, k, v and the JAX oracle's output, made once for the tests
    that share them."""
    rng = np.random.RandomState(hd)
    (jq, tq), (jk, tk), (jv, tv) = [
        _both((rng.randn(1, 1024, n, hd) * scale).astype(np.float32),
              "bfloat16") for n in (8, 1, 1)]
    return tq, tk, tv, np.asarray(jref.flash_attention(jq, jk, jv),
                                  np.float32)


@pytest.mark.parametrize("hd", [192, 256, 576])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_flash_tc_wide_model_meets_qwen_gate(hd, scale):
    """At the width-cut qwen shape, x0.5 and x2, the modelled arithmetic
    of hd 192's kernel and of the wider routes meets chip_smoke.py's bf16
    gate against the JAX oracle: rtol 2e-2, atol 5e-4."""
    tq, tk, tv, want = _qwen_cut_hd(hd, scale)
    assert _gate_excess(_tc_wrapped(tq, tk, tv), want, QWEN_RTOL) <= \
        QWEN_ATOL


@pytest.mark.parametrize("hd", [192, 256, 576])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_flash_tc_wide_single_bf16_p_misses_qwen_gate(hd, scale):
    """Why hd 192's kernel and the wider routes keep P as bf16 hi + lo: P
    rounded once to bf16 misses the same gate at the same inputs at every
    width and both scales."""
    tq, tk, tv, want = _qwen_cut_hd(hd, scale)
    assert _gate_excess(_tc_wrapped(tq, tk, tv, split_p=False), want,
                        QWEN_RTOL) > QWEN_ATOL


# ---------------------------------------------------------------------------
# dispatch and the CUDA wrappers' refusals
# ---------------------------------------------------------------------------

def test_ops_dispatch_cpu_goes_to_plain_versions():
    (_, q), (_, k), (_, v) = _qkv(1, 20, 4, 2, 16, "float32", 2)
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 64)
                         .astype(np.float32))
    s = torch.linspace(0.5, 1.5, 64)
    before = (RN.rmsnorm.launches, FA.flash_attention.launches)
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm(x, s))
    assert torch.equal(ops.flash_attention(q, k, v, window=5),
                       ref.flash_attention(q, k, v, window=5))
    assert (RN.rmsnorm.launches, FA.flash_attention.launches) == before
    with pytest.raises(ValueError, match="self-attention only"):
        ops.flash_attention(q[:, :5], k, v)


@pytest.mark.parametrize("bad,why", [("cpu", "not a CUDA device"),
                                     ("scale_dtype", "scale is torch.bfloat16"),
                                     ("scale_shape", "scale has shape"),
                                     ("strided", "must be contiguous"),
                                     ("float64", "not supported"),
                                     ("empty", "non-empty")])
def test_rmsnorm_wrapper_raises(bad, why):
    x = torch.ones(4, 8)
    s = torch.ones(8)
    if bad == "scale_dtype":
        s = s.bfloat16()
    elif bad == "scale_shape":
        s = torch.ones(4)
    elif bad == "strided":
        x = torch.ones(8, 4).t()
    elif bad == "float64":
        x, s = x.double(), s.double()
    elif bad == "empty":
        x = torch.ones(0, 8)
    before = RN.rmsnorm.launches
    with pytest.raises(ValueError, match=why):
        RN.rmsnorm(x, s)
    assert RN.rmsnorm.launches == before


@pytest.mark.parametrize("dtype,route,kernel", [
    (torch.bfloat16, "wgmma", "tensor-core kernel"),
    (torch.float32, "tf32x3",
     "tensor-core kernel, fp32 as three TF32 products")])
def test_flash_wrapper_routes_by_dtype(dtype, route, kernel):
    """bf16 goes to the tensor-core kernel, fp32 to the tensor-core one that
    runs each fp32 product as three TF32 products: the wrapper picks the
    route before its device check, whose refusal names it, and counts
    nothing."""
    assert FA.ROUTES[dtype] == route
    q, k, v = (torch.ones(1, 8, n, 16, dtype=dtype) for n in (4, 2, 2))
    before = (FA.flash_attention.launches,
              dict(FA.flash_attention.route_launches))
    with pytest.raises(ValueError, match=f"{dtype}: {kernel}.*not a CUDA "
                                         f"device"):
        FA.flash_attention(q, k, v)
    assert (FA.flash_attention.launches,
            FA.flash_attention.route_launches) == before


@pytest.mark.parametrize("bad,why", [("cpu", "not a CUDA device"),
                                     ("seq", "Sq == Skv"),
                                     ("groups", "not a positive multiple"),
                                     # hd 200 passes every check up to the
                                     # device's (fp32 padded to 224 on
                                     # tf32x3, bf16 to 256 on wgmma)
                                     pytest.param(
                                         "head_dim", r"three TF32 products\): "
                                         r"q is on cpu, not a CUDA device",
                                         id="head_dim-head dim 200"),
                                     pytest.param(
                                         "head_dim_bf16", r"bfloat16: "
                                         r"tensor-core kernel\): q is on "
                                         r"cpu, not a CUDA device",
                                         id="head_dim_bf16-head dim 200"),
                                     ("dtype", "v is torch.bfloat16"),
                                     ("strided", "k is not contiguous"),
                                     ("window", "window -1"),
                                     ("misaligned", "q is not 16-byte "
                                                    "aligned")])
def test_flash_wrapper_raises(bad, why):
    q, k, v = torch.ones(1, 8, 4, 16), torch.ones(1, 8, 2, 16), \
        torch.ones(1, 8, 2, 16)
    window = 0
    if bad == "seq":
        q = torch.ones(1, 6, 4, 16)
    elif bad == "groups":
        k = v = torch.ones(1, 8, 3, 16)
    elif bad == "head_dim":         # fp32 above the 192 tier, padded
        q, k, v = (torch.ones(1, 8, n, 200) for n in (4, 2, 2))
    elif bad == "head_dim_bf16":
        q, k, v = (torch.ones(1, 8, n, 200, dtype=torch.bfloat16)
                   for n in (4, 2, 2))
    elif bad == "dtype":
        v = v.bfloat16()
    elif bad == "strided":
        k = torch.ones(1, 2, 8, 16).transpose(1, 2)
    elif bad == "window":
        window = -1
    elif bad == "misaligned":       # TMA and 16-byte loads (the bf16 route)
        q = torch.ones(1 * 8 * 4 * 16 + 1, dtype=torch.bfloat16)[1:] \
            .view(1, 8, 4, 16)
        k, v = k.bfloat16(), v.bfloat16()
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match=why):
        FA.flash_attention(q, k, v, window=window)
    assert FA.flash_attention.launches == before


# ---------------------------------------------------------------------------
# head widths the kernels are not built for, and calls of 2^31 elements
# ---------------------------------------------------------------------------

def _plain_attend(q, k, v, causal, window, scale):
    return ref.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


@pytest.mark.parametrize("arch", [a for a in C.ARCH_IDS
                                  if C.get(a).family == "dense"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_config_head_dims_reach_the_device_check(arch, dtype):
    """Every dense config's head width passes the wrapper's checks up to the
    device refusal (nemotron-4-340b's hd 192 was refused before)."""
    hd = C.get(arch).hd
    q, k, v = (torch.ones(1, 4, n, hd, dtype=dtype) for n in (2, 1, 1))
    with pytest.raises(ValueError, match="q is on cpu, not a CUDA device"):
        FA._check(q, k, v, 0)
    assert FA.native_head_dim(hd) == hd


@pytest.mark.parametrize("hd", [8, 48, 80, 100, 170])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_padded_path_equals_unpadded_plain(hd, causal, window):
    """The wrapper's padding (fp32: zero columns up to the next multiple of
    32, the true 1/sqrt(hd) passed as the scale, the output cut back), run
    with the plain version, against the plain version at hd itself; fp32 at
    the sweep's tolerance (the scale is multiplied, not divided: last
    bits)."""
    (_, tq), (_, tk), (_, tv) = _qkv(2, 33, 4, 2, hd, "float32", hd)
    seen = []

    def attend(q, k, v, causal, window, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], scale))
        return _plain_attend(q, k, v, causal, window, scale)

    got = _fwd_padded(attend, tq, tk, tv, causal, window)
    wide = FA.native_head_dim(hd)
    assert wide > hd and seen == [(wide, wide, wide, 1.0 / math.sqrt(hd))]
    assert got.shape == tq.shape and got.is_contiguous()
    want = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FLASH_RTOL,
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_hd192_plain_matches_jax(dtype):
    """hd 192 is built natively: the path runs unpadded, and the plain
    version there meets the JAX oracle and the Pallas kernel (interpret
    mode) at the sweep's tolerance (fp32) and _tol (bf16)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 64, 4, 2, 192, dtype, 192)
    calls = []

    def attend(q, k, v, causal, window, scale):
        calls.append(q.shape[-1])
        return _plain_attend(q, k, v, causal, window, scale)

    got = _fwd_padded(attend, tq, tk, tv, True, 0)
    assert calls == [192] and got.dtype == tq.dtype
    rtol, atol = (FLASH_RTOL, FLASH_ATOL) if dtype == "float32" else \
        (TOL[dtype], TOL[dtype])
    _close(got, jref.flash_attention(jq, jk, jv), rtol, atol)
    _close(got, jops.flash_attention(jq, jk, jv, blk_q=64, blk_k=64,
                                     interpret=True), rtol, atol)


# ids as first written (B-S-H-Kv-hd-launches when a launch held fewer than
# 2^31 elements); a batch is now split only for the grid's 65,535 entries
@pytest.mark.parametrize("B,S,H,Kv,hd,n", [
    pytest.param(4, 1024, 64, 8, 128, 1, id="4-1024-64-8-128-1"),
    # stablelm prefill_32k: exactly 2^31 elements, one launch
    pytest.param(32, 32768, 32, 32, 64, 1, id="32-32768-32-32-64-2"),
    # more than 2^31 elements, one launch
    pytest.param(257, 1024, 64, 8, 128, 1, id="257-1024-64-8-128-2"),
    # past the grid's 65,535 batch entries a launch
    pytest.param(70000, 8, 2, 1, 16, 2, id="70000-8-2-1-16-2"),
    pytest.param(1, 1, 1, 1, 16, 1, id="1-1-1-1-16-1")])
def test_batch_chunks_cover_the_batch_below_2_31(B, S, H, Kv, hd, n):
    chunks = FA._batch_chunks(B)
    assert len(chunks) == n
    assert chunks[0][0] == 0 and chunks[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    sizes = [b1 - b0 for b0, b1 in chunks]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert all(s <= 65535 for s in sizes)
    # a launch's grid stays inside CUDA's limits for these shapes: below
    # 2^31 blocks along x on either kind of kernel
    for s in sizes:
        assert -(-S * (H // Kv) // 128) * Kv * s < 2 ** 31
        assert -(-S * (H // Kv) // 64) * -(-hd // 128) < 2 ** 31


def test_batch_chunks_refuse_one_entry_of_2_31():
    """One batch entry of 2^31 elements or more is taken whole: the
    launches split only over batch, for the grid, and every element offset
    is 64-bit (shown with meta tensors: no memory)."""
    assert FA._batch_chunks(1) == [(0, 1)]
    for S, H, Kv, hd in ((2 ** 18, 64, 8, 128), (131072, 128, 16, 128),
                         (2 ** 16, 128, 8, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.empty(1, S, n, hd, dtype=dtype, device="meta")
                       for n in (H, Kv, Kv))
            assert q.numel() >= 2 ** 31
            path = FA.route(dtype, hd, S, H // Kv)
            with pytest.raises(ValueError,
                               match=f"{FA._ROUTE_NAMES[path]}\\): q is on "
                                     f"meta, not a CUDA device"):
                FA._check(q, k, v, 256)


@pytest.mark.parametrize("hd", [64, 80])
def test_flash_check_takes_2_31_elements(hd):
    """stablelm-1.6b's prefill_32k shape (2^31 elements at hd 64) passes
    every check up to the device refusal (meta tensors: no memory), and
    expanded tensors are refused for their strides, not their size."""
    shape = (32, 32768, 32, hd)
    q, k, v = (torch.empty(*shape, dtype=torch.bfloat16, device="meta")
               for _ in range(3))
    assert q.numel() >= 2 ** 31
    with pytest.raises(ValueError, match="q is on meta, not a CUDA device"):
        FA._check(q, k, v, 0)
    q, k, v = (torch.ones(1, 1, 1, 1, dtype=torch.bfloat16).expand(*shape)
               for _ in range(3))
    with pytest.raises(ValueError, match="q is not contiguous"):
        FA._check(q, k, v, 0)


# ---------------------------------------------------------------------------
# head widths above the tensor-core kernel's 192
# ---------------------------------------------------------------------------

WIDE_HDS = [200, 256, 576, 1024]


@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_wide_path_plain_matches_jax(hd, causal, window):
    """The wrapper's path at a wide head width (fp32: 200 zero-padded to
    224; 256, 576 and 1,024 unpadded), run with the plain version, against
    the JAX oracle in fp32 at the sweep's tolerance."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 33, 4, 2, hd, "float32", hd)
    widths = []

    def attend(q, k, v, causal, window, scale):
        widths.append(q.shape[-1])
        return _plain_attend(q, k, v, causal, window, scale)

    got = _fwd_padded(attend, tq, tk, tv, causal, window)
    assert widths == [FA.native_head_dim(hd)] == [-(-hd // 32) * 32]
    assert got.shape == tq.shape and got.is_contiguous()
    _close(got, jref.flash_attention(jq, jk, jv, causal=causal,
                                     window=window), FLASH_RTOL, FLASH_ATOL)


@pytest.mark.parametrize("hd", WIDE_HDS)
def test_flash_wide_path_plain_matches_pallas(hd):
    """The same path against the Pallas kernel in interpret mode at one
    small shape (causal, window 5)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 24, 2, 1, hd, "float32", 3 * hd)
    got = _fwd_padded(_plain_attend, tq, tk, tv, True, 5)
    _close(got, jops.flash_attention(jq, jk, jv, window=5, blk_q=8,
                                     blk_k=8, interpret=True),
           FLASH_RTOL, FLASH_ATOL)


@pytest.mark.parametrize("hd", WIDE_HDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_check_takes_wide_head_dims(hd, dtype):
    """Every width above 192 passes the checks up to the device refusal
    (meta tensors): fp32 on the tensor cores as three TF32 products
    (``tf32x3``), bf16 on the tensor cores (hd whole up to 256, in column
    blocks above)."""
    q, k, v = (torch.empty(2, 64, n, hd, dtype=dtype, device="meta")
               for n in (8, 2, 2))
    if dtype == torch.bfloat16:
        path = "wgmma" if hd <= 256 else "wgmma_chunked"
    else:
        path = "tf32x3"
    assert FA.route(dtype, hd, 64, 4) == path
    with pytest.raises(ValueError, match=f"{FA._ROUTE_NAMES[path]}\\): q is "
                                         f"on meta, not a CUDA device"):
        FA._check(q, k, v, 0)


def test_flash_route_by_dtype_width_and_rows():
    """bf16 takes the tensor cores at every width while a kv head's folded
    rows fit 32 bits (hd whole up to 256, column blocks above), else the
    CUDA cores; fp32 always ``tf32x3`` (its blocks hold one head's
    positions, so no folded-row limit), at the next multiple of 32; every
    route has a C function, and fp32's CUDA-core kernels stay bound."""
    assert FA.route(torch.bfloat16, 192, 1024, 8) == "wgmma"
    assert FA.route(torch.bfloat16, 16, 1024, 8) == "wgmma"
    assert FA.route(torch.bfloat16, 200, 1024, 8) == "wgmma"
    assert FA.route(torch.bfloat16, 256, 1024, 8) == "wgmma"
    assert FA.route(torch.bfloat16, 257, 1024, 8) == "wgmma_chunked"
    assert FA.route(torch.bfloat16, 1024, 1024, 8) == "wgmma_chunked"
    assert all(FA.route(torch.bfloat16, hd, 2 ** 28 - 33, 8) in FA._TC_ROUTES
               for hd in range(193, 1025))
    # a kv head of 2^31 - 256 folded rows or more: the CUDA cores
    for hd, path in ((128, "cuda_core"), (256, "cuda_core"),
                     (1024, "hd_chunked")):
        assert FA.route(torch.bfloat16, hd, 2 ** 28, 8) == path
        assert FA.route(torch.bfloat16, hd, 2 ** 28 - 33, 8) in FA._TC_ROUTES
    for hd in (1, 128, 256, 257, 1024):
        assert FA.route(torch.float32, hd, 1024, 8) == "tf32x3"
        assert FA.route(torch.float32, hd, 2 ** 28, 8) == "tf32x3"
    assert set(FA.flash_attention.route_launches) == set(FA._ROUTE_NAMES)
    for path in ("cuda_core", "hd_chunked"):
        assert (torch.bfloat16, path) in FA._FNS
    assert FA._FNS[torch.float32, "cuda_core"] == "flash_attention_f32"
    for path in ("wgmma", "wgmma_chunked"):
        assert FA._FNS[torch.bfloat16, path] == "flash_attention_bf16"
    assert FA._FNS[torch.float32, "tf32x3"] == "flash_attention_f32_tf32x3"
    # hd 33-192's old kernel, bound as the new one's yardstick at 64, 128
    # and 192, on no route
    assert FA._FNS[torch.bfloat16, "wgmma_yardstick"] == \
        "flash_attention_bf16_yardstick"
    assert FA.YARDSTICK_DIMS == (64, 128, 192)
    assert "wgmma_yardstick" not in FA.flash_attention.route_launches
    assert FA.ROUTES[torch.float32] == "tf32x3" and "tf32x3" in FA._TC_ROUTES
    assert FA.native_head_dim(1) == 32 and FA.native_head_dim(193) == 224
    assert FA.native_head_dim(257) == 288 and FA.native_head_dim(256) == 256
    bf = torch.bfloat16
    assert FA.native_head_dim(193, bf) == 256
    assert FA.native_head_dim(256, bf) == 256
    assert FA.native_head_dim(257, bf) == 320
    assert FA.native_head_dim(576, bf) == 576
    assert FA.native_head_dim(1000, bf) == 1024


@pytest.mark.parametrize("hd,path", [(256, "wgmma"), (576, "wgmma_chunked")])
@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_flash_tensor_core_routes_refuse_misaligned(hd, path, name):
    """Both tensor-core routes read k and v by TMA and q in 16-byte pieces:
    a tensor off 16-byte alignment is refused, naming its route, before
    any launch."""
    shapes = {"q": (1, 8, 4, hd), "k": (1, 8, 2, hd), "v": (1, 8, 2, hd)}
    ts = {n: torch.ones(*sh, dtype=torch.bfloat16) for n, sh in shapes.items()}
    n = math.prod(shapes[name])
    ts[name] = torch.ones(n + 1, dtype=torch.bfloat16)[1:] \
        .view(*shapes[name])
    assert FA.route(torch.bfloat16, hd, 8, 2) == path
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match=f"{name} is not 16-byte aligned "
                                         f"\\(torch.bfloat16 runs the "
                                         f"{FA._ROUTE_NAMES[path]}\\)"):
        FA.flash_attention(ts["q"], ts["k"], ts["v"])
    assert FA.flash_attention.launches == before


@pytest.mark.parametrize("hd", [32, 128, 576])
@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_flash_tf32x3_refuses_misaligned(hd, name):
    """fp32 reads q, k and v by TMA: a tensor off 16-byte alignment is
    refused, naming the route, before any launch."""
    shapes = {"q": (1, 8, 4, hd), "k": (1, 8, 2, hd), "v": (1, 8, 2, hd)}
    ts = {n: torch.ones(*sh) for n, sh in shapes.items()}
    ts[name] = torch.ones(math.prod(shapes[name]) + 1)[1:] \
        .view(*shapes[name])
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match=f"{name} is not 16-byte aligned "
                                         f"\\(torch.float32 runs the "
                                         f"{FA._ROUTE_NAMES['tf32x3']}\\)"):
        FA.flash_attention(ts["q"], ts["k"], ts["v"])
    assert FA.flash_attention.launches == before


@pytest.mark.parametrize("hd", [300, 600])
def test_flash_bf16_wide_pads_to_a_multiple_of_64(hd):
    """bf16 above 256 is zero-padded to the next multiple of 64 (the
    column-block kernel's chunk), fp32 to the next multiple of 32
    (tf32x3's), with the true scale, and the output cut back: run with the
    plain version, equal to the unpadded plain version within _tol's 2e-2
    (fp32 at the sweep's tolerance)."""
    for dtype in ("bfloat16", "float32"):
        (_, tq), (_, tk), (_, tv) = _qkv(1, 40, 4, 2, hd, dtype, hd)
        widths = []

        def attend(q, k, v, causal, window, scale):
            widths.append(q.shape[-1])
            return _plain_attend(q, k, v, causal, window, scale)

        got = _fwd_padded(attend, tq, tk, tv, True, 7)
        want = ref.flash_attention(tq, tk, tv, causal=True, window=7)
        step = 64 if dtype == "bfloat16" else 32
        wide = -(-hd // step) * step
        assert widths == [wide] and got.shape == tq.shape
        tol = (TOL["bfloat16"],) * 2 if dtype == "bfloat16" else \
            (FLASH_RTOL, FLASH_ATOL)
        _close(got, want.float().numpy(), *tol)


def test_flash_check_refuses_positions_past_32_bits():
    q, k, v = (torch.empty(1, 2 ** 31, 1, 1, dtype=torch.bfloat16,
                           device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="positions in 32 bits"):
        FA._check(q, k, v, 0)
