"""The fp32 flash forward's three-product TF32 split (route ``tf32x3``),
modelled on the CPU, against the JAX package.

``_tf32x3_fwd_model`` computes what ``flash_kernel_tf32x3`` in
``csrc/flash_attention.cu`` computes, in its order and rounding: each fp32
operand x split into hi = trunc(x) (the TF32 value the tensor core reads
for a raw fp32 x) and lo = tf32(x - hi) (``cvt.rna``); a product as hi hi'
+ hi lo' + lo hi'; every tensor-core instruction (a k step of 8) adding its
8 products to the accumulator and truncating the sum to fp32, as a probe
of the card's tensor cores read it (PERF.md, section 6); per kv tile of 64
positions S summed over 32-column chunks of hd, each a fresh chain of 12
instructions, the even chunks on warpgroup 0 and the odd on warpgroup 1,
each warpgroup's sum in fp32 and the two added; the online softmax in fp32
in the log2 domain with the scale applied after the product (whole tiles
one FMA a score, tiles that cross a mask edge scaled first and masked with
-1e30); P.V per tile as fresh chains of 24 instructions over the tile's 64
positions, added to the rescaled output in fp32; out = acc * (1 / l).

It is held elementwise at the card's fp32 gate (rtol 5e-5, atol 5e-6:
``chip_smoke.py``'s FLASH_RTOL / FLASH_ATOL) against JAX's
``repro.kernels.ref.flash_attention`` over the flash sweep at hd 64-256,
hd 576 and 1,024, the wrapper's zero-padding to a multiple of 32 and a
width-cut qwen1.5-110b shape, against the Pallas kernel in interpret mode
at one small shape, and at the peaked qwen cut (x2) within 4x the plain
fp32 version's distance from an fp64 attention (``chip_smoke.py``'s
``held_exact``). The choices the kernel makes are the model's: scaling the
scores after the product (not q first) and ``ex2.approx`` (bounded here by
its largest relative error) both hold the gates, and one TF32 product
(``terms=1``) misses them.

JAX runs at ``highest`` matmul precision (``tests/conftest.py``); inputs are
made with numpy from a seed and handed to both packages.
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
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from test_torch_bwd_kernels import _tf32, _trunc, _x3_mm

FLASH_RTOL, FLASH_ATOL = 5e-5, 5e-6     # chip_smoke.py FLASH_RTOL / _ATOL
EXACT_FACTOR = 4.0                      # chip_smoke.py QWEN_FLASH_EXACT_FACTOR
LOG2E = 1.4426950408889634
TILE, COLS, KSTEP = 64, 32, 8       # kv tile, hd chunk, one instruction's k
# ex2.approx.ftz.f32's largest relative error (PTX ISA: 2^-22 over the
# reduced range, plus the input's rounding)
EX2_APPROX_REL = 2.0 ** -21
FLASH_SHAPES = [(1, 64, 4, 4), (2, 129, 8, 4), (1, 200, 8, 1)]
MASKS = [(True, 0), (True, 37), (False, 0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# fp64 bits below an fp32 significand (52 - 23 of the mantissa)
_LOW29 = ~((1 << 29) - 1)


def _trunc32(x):
    """fp64 x rounded toward zero to fp32's 24-bit significand (kept in
    fp64): the tensor core's fp32 accumulation drops the bits below the
    sum's last place."""
    return (x.view(torch.int64) & _LOW29).view(torch.float64)


def _split(x):
    """(hi, lo) as the tensor core reads them, in fp64: hi = trunc(x), lo =
    tf32(x - hi)."""
    hi = _trunc(x)
    return hi.double(), _tf32(x - hi).double()


def _chain(a, b, terms=3, acc="truncating"):
    """a @ b, a [..., M, K] and b [..., K, N] fp32 with K a multiple of 8,
    as one fresh chain of tensor-core instructions: per k step of 8, hi hi'
    then hi lo' then lo hi', each instruction's 8 products added exactly to
    the accumulator and the sum truncated to fp32 (``acc="truncating"``).
    ``acc="fp32"``: the backward's model of a chain (``_x3_mm``, the three
    terms in fp32 matmuls), for comparison."""
    if acc == "fp32":
        return _x3_mm(a, b, terms)
    (ah, al), (bh, bl) = _split(a), _split(b)
    pairs = ((ah, bh), (ah, bl), (al, bh))[:terms]
    steps = [(x[..., k0:k0 + KSTEP], y[..., k0:k0 + KSTEP, :])
             for k0 in range(0, a.shape[-1], KSTEP) for x, y in pairs]
    prods = torch.stack([x for x, _ in steps], -3) @ \
        torch.stack([y for _, y in steps], -3)     # [..., steps, M, N]
    out = _trunc32(prods[..., 0, :, :])
    for j in range(1, len(steps)):
        out = _trunc32(out + prods[..., j, :, :])
    return out.float()


def _visible(qpos, kpos, S, causal, window):
    ok = (qpos[:, None] < S) & (kpos[None, :] < S)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def _tf32x3_fwd_model(q, k, v, *, causal=True, window=0, scale=None,
                      terms=3, acc="truncating", scale_first=False,
                      ex2_err=0.0, with_lse=False):
    """What ``flash_kernel_tf32x3`` computes (module docstring), fp32 q
    [B,S,H,hd] and k/v [B,S,Kv,hd], hd a multiple of 32 (the wrapper
    pads); ``scale`` the one the wrapper passes, by default 1/sqrt(hd).
    Options for the choices the kernel does not make: ``terms=1`` (one TF32
    product), ``acc="fp32"`` (chains summed without truncation),
    ``scale_first`` (q scaled in fp32 before the split, as ``_fa_kernel``
    does), ``ex2_err`` (every exp2 off by this relative error, the worst
    case of ``ex2.approx``). Returns out [B,S,H,hd] fp32, and with
    ``with_lse`` each row's log-sum-exp [B,H,S] as the kernel writes it."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    assert hd % COLS == 0
    scale = torch.tensor(1.0 / math.sqrt(hd) if scale is None else scale,
                         dtype=torch.float32)
    c2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    heads = torch.arange(H) // G
    qf = q.float().transpose(1, 2)                          # [B, H, S, hd]
    kf, vf = (t.float().transpose(1, 2)[:, heads] for t in (k, v))
    if scale_first:
        qf, c2 = qf * scale, torch.tensor(LOG2E, dtype=torch.float32)

    def ex2(t):
        return torch.exp2(t) * (1.0 + ex2_err)

    pos = torch.arange(S)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    out = torch.zeros(B, H, S, hd)
    neg = torch.tensor(-1e30)
    for k0 in range(0, S, TILE):
        ks = slice(k0, k0 + TILE)
        # the rows that see this tile (causal: from its first position; the
        # rows the kernel's q tiles visit it for without seeing it add exact
        # zeros, or junk that the first tile they see wipes)
        r0 = k0 if causal else 0
        rs = slice(r0, S)
        # S: warpgroup w sums chunks w, w + 2, ... in fp32, each a fresh
        # chain; then the two sums are added
        parts = [None, None]
        for c in range(hd // COLS):
            cs = slice(c * COLS, (c + 1) * COLS)
            x = _chain(qf[..., rs, cs], kf[..., ks, cs].transpose(-1, -2),
                       terms, acc)
            parts[c % 2] = x if parts[c % 2] is None else parts[c % 2] + x
        st = parts[0] if parts[1] is None else parts[0] + parts[1]
        ok = _visible(pos[rs], pos[ks], S, causal, window)
        # a tile is whole for a 64-row q tile when no pair of it is masked
        whole = torch.tensor([bool(ok[r - r0:r - r0 + TILE].all()) and
                              r + TILE <= S and k0 + TILE <= S
                              for r in range(0, S, TILE)])
        whole = whole.repeat_interleave(TILE)[r0:S, None]
        t = torch.where(ok, st * c2, neg)
        mx = torch.where(whole, st.amax(-1, keepdim=True) * c2,
                         t.amax(-1, keepdim=True))
        m_new = torch.maximum(m[..., rs, :], mx)
        fma = (st.double() * c2.double() - m_new.double()).float()
        p = ex2(torch.where(whole, fma, t - m_new))
        alpha = ex2(m[..., rs, :] - m_new)
        l[..., rs, :] = l[..., rs, :] * alpha + p.sum(-1, keepdim=True)
        out[..., rs, :] = out[..., rs, :] * alpha + \
            _chain(p, vf[..., ks, :], terms, acc)
        m[..., rs, :] = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    res = (out * (1.0 / l)).transpose(1, 2).contiguous()
    if not with_lse:
        return res
    lse = math.log(2) * (m + torch.log2(l))
    return res, lse[..., 0]


def _qkv(B, S, H, Kv, hd, seed, scale=0.5):
    """fp32 q, k, v from numpy as (jax, torch) pairs (the sweep's x0.5)."""
    rng = np.random.RandomState(seed)
    return [(jnp.asarray(a), torch.from_numpy(a)) for a in (
        (rng.randn(B, S, n, hd) * scale).astype(np.float32)
        for n in (H, Kv, Kv))]


def _excess(got, want, rtol=FLASH_RTOL):
    """max(|got - want| - rtol |want|): allclose at (rtol, atol) holds iff
    this is at most atol."""
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(got.numpy() - w) - rtol * np.abs(w)))


def _model_vs_jax(B, S, H, Kv, hd, causal, window, seed, padded=False,
                  **opts):
    """The model's gate excess against the JAX oracle (through the
    wrapper's zero-padding with ``padded``)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, Kv, hd, seed)
    if padded:
        def attend(q, k, v, causal, window, scale):
            return _tf32x3_fwd_model(q, k, v, causal=causal, window=window,
                                     scale=scale, **opts)

        got = FA._pad_call(attend, (tq, tk, tv),
                           FA.native_head_dim(hd, torch.float32), causal,
                           window)
    else:
        got = _tf32x3_fwd_model(tq, tk, tv, causal=causal, window=window,
                                **opts)
    assert got.shape == tq.shape and got.dtype == torch.float32
    return _excess(got, jref.flash_attention(jq, jk, jv, causal=causal,
                                             window=window))


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,S,H,Kv", FLASH_SHAPES, ids=lambda s: str(s))
def test_flash_tf32x3_model_matches_jax_oracle(B, S, H, Kv, causal, window,
                                               hd):
    assert _model_vs_jax(B, S, H, Kv, hd, causal, window, S + H + hd) <= \
        FLASH_ATOL


@pytest.mark.parametrize("hd", [576, 1024])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_tf32x3_wide_model_matches_jax_oracle(causal, window, hd):
    """hd 576 and 1,024 (18 and 32 chunks, two warpgroups' sums) at the
    sweep's GQA shape."""
    assert _model_vs_jax(*FLASH_SHAPES[1], hd, causal, window, hd) <= \
        FLASH_ATOL


@pytest.mark.parametrize("hd", [16, 80, 150, 300])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_tf32x3_padded_model_matches_jax_oracle(causal, window, hd):
    """The wrapper's zero-padding to a multiple of 32 (16 -> 32, 80 -> 96,
    150 -> 160, 300 -> 320; an odd chunk count leaves warpgroup 1 without
    a chunk in the last product step) with the true scale, the model at
    the padded width, against JAX on the unpadded inputs."""
    assert FA.native_head_dim(hd, torch.float32) == -(-hd // 32) * 32 > hd
    assert _model_vs_jax(*FLASH_SHAPES[1], hd, causal, window, 5 + hd,
                         padded=True) <= FLASH_ATOL


def test_flash_tf32x3_model_matches_pallas():
    """Against the Pallas kernel in interpret mode at one small shape
    (causal, window 5)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 72, 4, 2, 64, 9)
    got = _tf32x3_fwd_model(tq, tk, tv, window=5)
    want = jops.flash_attention(jq, jk, jv, window=5, blk_q=8, blk_k=8,
                                interpret=True)
    assert _excess(got, want) <= FLASH_ATOL


@functools.lru_cache(maxsize=None)
def _qwen_cut(scale):
    """qwen1.5-110b's prefill attention cut in width: S = 1,024, G = 8, one
    kv head, hd 128, inputs N(0, 1) x scale, fp32; the torch q, k, v, the
    JAX oracle's output and an fp64 attention, made once."""
    rng = np.random.RandomState(25)
    arrs = [(rng.randn(1, 1024, n, 128) * scale).astype(np.float32)
            for n in (8, 1, 1)]
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    want = np.asarray(jref.flash_attention(*(jnp.asarray(a) for a in arrs)),
                      np.float32)
    return tq, tk, tv, want, _exact(tq, tk, tv)


def _exact(q, k, v):
    """Causal GQA attention in fp64 (``chip_smoke.py``'s
    exact_causal_attention)."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.double().reshape(B, S, Kv, H // Kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / math.sqrt(hd)
    ok = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.double()) \
        .reshape(B, S, H, hd)


@functools.lru_cache(maxsize=None)
def _qwen_model(scale, **opts):
    tq, tk, tv, _, _ = _qwen_cut(scale)
    return _tf32x3_fwd_model(tq, tk, tv, **opts)


@pytest.mark.parametrize("opts", [
    {}, {"scale_first": True}, {"ex2_err": EX2_APPROX_REL},
    {"ex2_err": -EX2_APPROX_REL}], ids=["kernel", "scale_first",
                                        "ex2_high", "ex2_low"])
def test_flash_tf32x3_model_meets_the_gate_at_a_qwen_cut(opts):
    """At the width-cut qwen shape with the sweep's x0.5 inputs, the
    kernel's arithmetic meets the elementwise fp32 gate against JAX; so do
    the scale applied to q first and exp2 off by ex2.approx's largest
    error either way, so the kernel's choices (the scale after the
    product, as the plain version and the backward do; ex2.approx, as
    every flash kernel here) cost nothing at this gate."""
    _, _, _, want, _ = _qwen_cut(0.5)
    assert _excess(_qwen_model(0.5, **opts), want) <= FLASH_ATOL


def _exact_ratio(got, plain, exact):
    return float((got.double() - exact).abs().max() /
                 (plain.double() - exact).abs().max())


@pytest.mark.parametrize("opts", [{}, {"acc": "fp32"}],
                         ids=["truncating", "fp32_chains"])
def test_flash_tf32x3_model_meets_the_peaked_qwen_gate(opts):
    """At the qwen cut with x2 inputs (score std 4, peaked: a score's error
    becomes the same relative error in its probability) the model stays
    within 4x the plain fp32 version's distance from an fp64 attention,
    with the tensor core's truncating accumulation and without it."""
    tq, tk, tv, _, exact = _qwen_cut(2.0)
    plain = ref.flash_attention(tq, tk, tv)
    assert _exact_ratio(_qwen_model(2.0, **opts), plain, exact) <= \
        EXACT_FACTOR


def test_flash_tf32x3_one_tf32_product_misses_the_gates():
    """The split is what holds the gates: the same model with hi hi' alone
    (one TF32 product, up to 2^-10 of each operand dropped) misses the
    elementwise gate at the qwen cut x0.5 and the fp64 gate at x2."""
    _, _, _, want, _ = _qwen_cut(0.5)
    assert _excess(_qwen_model(0.5, terms=1), want) > FLASH_ATOL
    tq, tk, tv, _, exact = _qwen_cut(2.0)
    plain = ref.flash_attention(tq, tk, tv)
    assert _exact_ratio(_qwen_model(2.0, terms=1), plain, exact) > \
        EXACT_FACTOR


def test_flash_tf32x3_model_lse_matches_the_plain_lse():
    """The lse the kernel writes (ln 2 (m + log2 l), m and l in the log2
    domain) within chip_smoke.py's TRAIN_LSE_TOL of the plain lse, at the
    sweep's GQA shape under a window."""
    (_, tq), (_, tk), (_, tv) = _qkv(*FLASH_SHAPES[1], 96, 4)
    _, got = _tf32x3_fwd_model(tq, tk, tv, window=37, with_lse=True)
    _, want = ref.flash_attention(tq, tk, tv, window=37, with_lse=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    # The model's distances at the cases above (the numbers PERF.md quotes):
    # PYTHONPATH=src:tests python tests/test_torch_fwd_kernels.py
    torch.set_num_threads(1)
    sweep = max(_model_vs_jax(B, S, H, Kv, hd, c, w, S + H + hd)
                for B, S, H, Kv in FLASH_SHAPES for c, w in MASKS
                for hd in (64, 128, 192, 256))
    wide = max(_model_vs_jax(*FLASH_SHAPES[1], hd, c, w, hd)
               for c, w in MASKS for hd in (576, 1024))
    padded = max(_model_vs_jax(*FLASH_SHAPES[1], hd, c, w, 5 + hd,
                               padded=True)
                 for c, w in MASKS for hd in (16, 80, 150, 300))
    print(f"gate excess (at most atol {FLASH_ATOL} passes): sweep "
          f"{sweep:.3e}, hd 576/1,024 {wide:.3e}, padded {padded:.3e}")
    _, _, _, want, _ = _qwen_cut(0.5)
    tq, tk, tv, _, exact = _qwen_cut(2.0)
    plain = ref.flash_attention(tq, tk, tv)
    for name, opts in (("kernel", {}), ("scale_first", {"scale_first": True}),
                       ("ex2 +2^-21", {"ex2_err": EX2_APPROX_REL}),
                       ("ex2 -2^-21", {"ex2_err": -EX2_APPROX_REL}),
                       ("fp32 chains", {"acc": "fp32"}),
                       ("one TF32 product", {"terms": 1})):
        print(f"{name}: qwen cut x0.5 gate excess "
              f"{_excess(_qwen_model(0.5, **opts), want):.3e}; x2 "
              f"max|model-exact| / max|plain-exact| "
              f"{_exact_ratio(_qwen_model(2.0, **opts), plain, exact):.3f}")
