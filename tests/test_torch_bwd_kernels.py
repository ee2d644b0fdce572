"""The port's two backward kernels, modelled and dispatched on the CPU,
against the JAX package.

- ``ops.flash_attention_bwd`` / ``ops.lstm_seq_bwd`` send CPU tensors to the
  plain versions and launch nothing; the CUDA wrappers refuse CPU tensors
  and the dtypes and shapes the kernels do not take, and their modules
  build nothing when imported; ``bwd_route`` by (dtype, hd).
- A CPU model of the bf16 tensor-core backward's rounding (q, k, v, dout,
  out in bf16; P and dS rounded once to bf16 before their products; fp32
  accumulation in the kernels' tile order; dq, dk, dv stored in bf16)
  against JAX's ``_fa_bwd`` in fp32 on the same numpy inputs, over the flash
  sweep at the tensor-core widths (64, 128, 192, 256), width-cut
  qwen1.5-110b and nemotron-4-340b shapes and the wrapper's zero-padding
  (hd 80, 150, 200), at the card's gate: 2e-2 of max |grad| (chip_smoke.py's
  TRAIN_GRAD_TOL); the padding path with the plain backward against the
  unpadded plain backward and against JAX, one bf16 step apart.
- ``ref.lstm_seq_bwd`` and a CPU model of ``lstm_seq_bwd_kernel``'s fixed
  summation order (each dh_next[j] as four fmaf chains over a gate block,
  added as (p0 + p1) + (p2 + p3)) against ``jax.grad`` of the reference's
  ``lax.scan`` within 2e-5 (``tests/test_kernels.py::_tol``, fp32): dz of
  every step (the gradient of a zero added to z), dh0 and dc0.
- ``_Seq.backward`` and ``FlashAttention.backward`` reach the ``ops`` names,
  so a patch of those names (``chip_smoke.py::plain_kernels``) takes them.

JAX runs at ``highest`` matmul precision (``tests/conftest.py``); inputs are
made with numpy from a seed and handed to both packages.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import lstm_cell as K
from repro_torch.kernels import ops, ref
from repro_torch.models import lstm as TLSTM

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_GATE = 2e-2            # chip_smoke.py TRAIN_GRAD_TOL: of max |grad|
LOG2E = 1.4426950408889634
TILE = 64                   # the tensor-core backward's tiles, either side
# the flash sweep of tests/test_kernels.py (B, S, H, Kv), run at the
# tensor-core kernels' widths
SWEEP = [(1, 64, 4, 4), (2, 129, 8, 4), (1, 200, 8, 1)]
MASKS = [(True, 0), (True, 37), (False, 0)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a: np.ndarray):
    """fp32 numpy -> (jax fp32 array, torch bf16 tensor) of the same bf16
    values (rounded once, by JAX)."""
    j = jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)
    return j, torch.from_numpy(np.array(j)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# (a) dispatch: CPU tensors go to the plain versions, nothing launches
# ---------------------------------------------------------------------------

def _fa_inputs(B, S, H, Kv, hd, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, n, hd, generator=g).to(dtype)
                   for n in (H, Kv, Kv, H))
    out, lse = ref.flash_attention(q, k, v, causal=True, with_lse=True)
    return q, k, v, out, lse, do


def test_ops_flash_bwd_on_the_cpu_is_the_plain_version():
    args = _fa_inputs(1, 40, 4, 2, 16, seed=1)
    before = (FA.flash_attention_bwd.launches,
              dict(FA.flash_attention_bwd.route_launches))
    got = ops.flash_attention_bwd(*args, causal=True, window=5, chunk=16)
    want = ref.flash_attention_bwd(*args, causal=True, window=5, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (FA.flash_attention_bwd.launches,
            FA.flash_attention_bwd.route_launches) == before


def _seq_state(T, B, Din, H, seed, dtype=torch.float32):
    """A forward's saved state from numpy inputs: (x, h0, c0, w, b, hs, cs,
    gates) as torch tensors of ``dtype``."""
    rng = np.random.RandomState(seed)
    x, h0, c0 = (rng.randn(*s).astype(np.float32)
                 for s in ((T, B, Din), (B, H), (B, H)))
    w = (rng.randn(Din + H, 4 * H) * 0.1).astype(np.float32)
    b = (rng.randn(4 * H) * 0.1).astype(np.float32)
    ts = [torch.from_numpy(a).to(dtype) for a in (x, h0 * 0.5, c0 * 0.5, w,
                                                  b)]
    return (*ts, *ref.lstm_seq(*ts))


def test_ops_lstm_seq_bwd_on_the_cpu_is_the_plain_version():
    x, h0, c0, w, b, hs, cs, gates = _seq_state(5, 3, 4, 6, seed=2)
    dhs = torch.randn(5, 3, 6)
    before = K.lstm_seq_bwd.launches
    got = ops.lstm_seq_bwd(dhs, gates, cs, c0, w[4:])
    want = ref.lstm_seq_bwd(dhs, gates, cs, c0, w[4:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert got[0].shape == (5, 3, 24) and got[1].shape == got[2].shape == \
        (3, 6)
    assert K.lstm_seq_bwd.launches == before


# ---------------------------------------------------------------------------
# (b) the CUDA wrappers refuse, and build nothing at import
# ---------------------------------------------------------------------------

def test_kernel_modules_import_without_building():
    """Importing the wrappers (as every test here did) compiled and loaded
    nothing: the libraries are built at a kernel's first launch."""
    assert FA.build_bwd.cache_info().currsize == 0
    assert FA.build.cache_info().currsize == 0
    assert K.build.cache_info().currsize == 0


@pytest.mark.parametrize("bad,why", [
    ("cpu", r"bfloat16 hd 64: tensor-core kernel\): q is on cpu, not a CUDA "
            r"device"),
    ("cpu_f32", r"float32 hd 64: CUDA-core kernel\): q is on cpu"),
    ("cpu_bf16_hd32", r"bfloat16 hd 32: tensor-core kernel\): q is on "
                      r"cpu"),
    ("cpu_bf16_hd192", r"bfloat16 hd 192: tensor-core kernel\): q is on "
                       r"cpu"),
    ("cpu_bf16_hd320", r"bfloat16 hd 320: CUDA-core kernel\): q is on "
                       r"cpu"),
    ("float64", "dtype torch.float64 not supported"),
    ("dtype", "dout is torch.float32, q is torch.bfloat16"),
    ("lse_dtype", "lse is torch.bfloat16, want torch.float32"),
    ("lse_shape", r"lse has shape \(1, 2, 63\)"),
    ("out_shape", "out has shape"),
    ("groups", "not a positive multiple"),
    ("strided", "dout is not contiguous"),
    ("window", "window -1"),
    ("misaligned", "v is not 16-byte aligned"),
    ("misaligned_hd192", "v is not 16-byte aligned"),
    # a padded width reads the wrapper's aligned copies, not v
    ("misaligned_hd80", r"bfloat16 hd 80: tensor-core kernel\): q is on "
                        r"cpu")])
def test_flash_bwd_wrapper_raises(bad, why):
    hd = int(bad.rsplit("_hd", 1)[1]) if "_hd" in bad else 64
    dt = torch.float32 if bad == "cpu_f32" else torch.bfloat16
    q, k, v, out, do = (torch.zeros(1, 64, n, hd, dtype=dt)
                        for n in (2, 1, 1, 2, 2))
    lse = torch.zeros(1, 2, 64)
    window = 0
    if bad == "float64":
        q, k, v, out, do = (t.double() for t in (q, k, v, out, do))
    elif bad == "dtype":
        do = do.float()
    elif bad == "lse_dtype":
        lse = lse.bfloat16()
    elif bad == "lse_shape":
        lse = lse[..., :63]
    elif bad == "out_shape":
        out = out[:, :, :1]
    elif bad == "groups":
        k = v = torch.zeros(1, 64, 3, hd, dtype=dt)
    elif bad == "strided":
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "window":
        window = -1
    elif bad.startswith("misaligned"):
        v = torch.zeros(64 * hd + 1, dtype=dt)[1:].view(1, 64, 1, hd)
    before = (FA.flash_attention_bwd.launches,
              dict(FA.flash_attention_bwd.route_launches))
    with pytest.raises(ValueError, match=why):
        FA.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    assert (FA.flash_attention_bwd.launches,
            FA.flash_attention_bwd.route_launches) == before


@pytest.mark.parametrize("bad,why", [
    ("cpu", "dhs is on cpu, not a CUDA device"),
    ("dtype", "cs is torch.float64, want torch.float32"),
    ("gates_dtype", "gates is torch.bfloat16, want torch.float32"),
    ("float64", "dtype torch.float64 not supported"),
    ("gates_shape", "gates has shape"),
    ("w_h", r"w_h has shape \(7, 24\), want \(6, 24\)"),
    ("strided", "dhs is not contiguous"),
    ("rank", "dhs must be 3-D"),
    ("empty", "empty shape")])
def test_lstm_seq_bwd_wrapper_raises(bad, why):
    x, h0, c0, w, b, hs, cs, gates = _seq_state(4, 3, 5, 6, seed=3)
    dhs = torch.ones(4, 3, 6)
    w_h = w[5:]
    if bad == "dtype":
        cs = cs.double()
    elif bad == "gates_dtype":
        gates = gates.bfloat16()
    elif bad == "float64":
        dhs, cs, c0, w_h = (t.double() for t in (dhs, cs, c0, w_h))
    elif bad == "gates_shape":
        gates = gates[..., :-1]
    elif bad == "w_h":
        w_h = w[4:]
    elif bad == "strided":
        dhs = dhs.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "rank":
        dhs = dhs[0]
    elif bad == "empty":
        dhs = dhs[:0]
    before = K.lstm_seq_bwd.launches
    with pytest.raises(ValueError, match=f"lstm_seq_bwd kernel: {why}"):
        K.lstm_seq_bwd(dhs, gates, cs, c0, w_h)
    assert K.lstm_seq_bwd.launches == before


# ---------------------------------------------------------------------------
# (c) the backward's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 192, "wgmma"),
    (torch.bfloat16, 576, "cuda_core"), (torch.float32, 64, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 1024, "cuda_core"),
    (torch.bfloat16, 1, "wgmma"), (torch.bfloat16, 150, "wgmma"),
    (torch.bfloat16, 255, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 257, "cuda_core"), (torch.float32, 192, "cuda_core"),
    (torch.float32, 256, "cuda_core")])
def test_flash_bwd_route_by_dtype_and_width(dtype, hd, route):
    assert FA.bwd_route(dtype, hd) == route
    assert set(FA.flash_attention_bwd.route_launches) == {"wgmma",
                                                          "cuda_core"}


# ---------------------------------------------------------------------------
# (d) the tensor-core backward's rounding, modelled, against JAX's _fa_bwd
# ---------------------------------------------------------------------------

def _visible(qpos, kpos, S, causal, window):
    ok = (qpos[:, None] < S) & (kpos[None, :] < S)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def _bf(t):
    return t.bfloat16().float()


def _tc_bwd_model(q, k, v, out, lse, dout, causal, window, scale=None):
    """What flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma (at hd 192 and 256
    flash_bwd_dkdv_wgmma_split, whose two warpgroups form the same P^T and
    dS^T from the same S^T) compute, in their rounding: q, k, v, out, dout
    bf16 (exact in fp32); D = rowsum(dout * out) in fp32; per 64 x 64 tile
    s = q k^T and dP = dout v^T in fp32, P = 2^(s * scale * log2(e) - lse *
    log2(e)) (0 where masked), dS = P (dP - D) scale; P and dS rounded once
    to bf16 before their products; dq summed over kv tiles in order, dk and
    dv over (query head of the group, q tile) in order, in fp32; each stored
    once in bf16. Tiles the kernels skip are fully masked and add exact
    zeros here. ``scale`` is the one the wrapper passes (1/sqrt(hd) of the
    unpadded width), by default 1/sqrt(hd)."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    scale = torch.tensor(1.0 / math.sqrt(hd) if scale is None else scale,
                         dtype=torch.float32)
    c2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf, of, dof = (t.float().transpose(1, 2)
                           for t in (q, k, v, out, dout))   # [B, heads, S, hd]
    D = (dof * of).sum(-1)                                  # [B, H, S]
    lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    kv_of = torch.arange(H) // G
    pos = torch.arange(S)
    n_t = -(-S // TILE)

    def tile_terms(qr, dor, kc, vc, lse_r, d_r, qpos, kpos):
        s = qr @ kc.transpose(-1, -2)
        dp = dor @ vc.transpose(-1, -2)
        ok = _visible(qpos, kpos, S, causal, window)
        p = torch.where(ok, torch.exp2(s * c2 - lse_r[..., None]),
                        torch.zeros(()))
        ds = p * (dp - d_r[..., None]) * scale
        return _bf(p), _bf(ds)

    dq = torch.zeros(B, H, S, hd)
    for t in range(n_t):                                    # launch 1
        ks = slice(t * TILE, (t + 1) * TILE)
        kc, vc = kf[:, kv_of, ks], vf[:, kv_of, ks]
        _, ds = tile_terms(qf, dof, kc, vc, lse2, D, pos, pos[ks])
        dq = dq + ds @ kc
    dk = torch.zeros(B, Kv, S, hd)
    dv = torch.zeros(B, Kv, S, hd)
    for g in range(G):                                      # launch 2
        hs = torch.arange(Kv) * G + g
        for t in range(n_t):
            qs = slice(t * TILE, (t + 1) * TILE)
            qr, dor = qf[:, hs, qs], dof[:, hs, qs]
            p, ds = tile_terms(qr, dor, kf, vf, lse2[:, hs, qs], D[:, hs, qs],
                               pos[qs], pos)
            dv = dv + p.transpose(-1, -2) @ dor
            dk = dk + ds.transpose(-1, -2) @ qr
    return tuple(x.transpose(1, 2).bfloat16() for x in (dq, dk, dv))


def _jax_fa_bwd(jq, jk, jv, jdo, causal, window):
    """JAX's forward (out, lse) and ``_fa_bwd`` in fp32."""
    B, S = jq.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    kvpos = jnp.arange(S, dtype=jnp.int32)
    out, lse = JL._flash_fwd(jq, jk, jv, pos, kvpos, None, causal=causal,
                             window=window, chunk=S)
    res = (jq, jk, jv, pos, kvpos, out, lse)
    return out, lse, JL._fa_bwd(causal, window, S, res, jdo)[:3]


def _model_vs_jax(arrs, causal, window):
    """The model's worst max|model - JAX| / max|JAX| over dq, dk, dv."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_bf16(a) for a in arrs)
    jout, jlse, want = _jax_fa_bwd(jq, jk, jv, jdo, causal, window)
    B, S, H, _ = tq.shape
    tout = torch.from_numpy(np.array(jout)).bfloat16()
    tlse = torch.from_numpy(np.array(jlse)).reshape(B, H, S)
    got = _tc_bwd_model(tq, tk, tv, tout, tlse, tdo, causal, window)
    errs = []
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        errs.append(float(np.max(np.abs(g.float().numpy() - w)) /
                          np.max(np.abs(w))))
    return errs


@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,S,H,Kv", SWEEP, ids=lambda s: str(s))
def test_flash_bwd_tc_model_meets_the_gate_against_jax(B, S, H, Kv, causal,
                                                       window, hd):
    rng = np.random.RandomState(S + H + hd)
    arrs = [rng.randn(B, S, n, hd).astype(np.float32)
            for n in (H, Kv, Kv, H)]
    errs = _model_vs_jax(arrs, causal, window)
    assert max(errs) <= GRAD_GATE, errs


@pytest.mark.parametrize("Kv", [1, 2])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_flash_bwd_tc_model_meets_the_gate_at_a_qwen_cut(Kv, scale):
    """qwen1.5-110b's training attention cut in width: S = 1,024, G = 8,
    hd = 128, Kv kv heads; inputs N(0, 1) x scale (x0.5 a near-uniform
    softmax, x2 a peaked one), causal."""
    rng = np.random.RandomState(Kv)
    arrs = [(rng.randn(1, 1024, n, 128) * scale).astype(np.float32)
            for n in (8 * Kv, Kv, Kv, 8 * Kv)]
    errs = _model_vs_jax(arrs, True, 0)
    assert max(errs) <= GRAD_GATE, errs


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_flash_bwd_tc_model_meets_the_gate_at_a_nemotron_cut(scale):
    """nemotron-4-340b's training attention cut in width: S = 1,024, G = 12
    (96 query heads over 8 kv heads), one kv head, hd 192 (the split dk/dv
    kernel's width, built natively), inputs N(0, 1) x scale, causal."""
    rng = np.random.RandomState(192)
    arrs = [(rng.randn(1, 1024, n, 192) * scale).astype(np.float32)
            for n in (12, 1, 1, 12)]
    errs = _model_vs_jax(arrs, True, 0)
    assert max(errs) <= GRAD_GATE, errs


# ---------------------------------------------------------------------------
# (d') the wrapper's zero-padding to the tensor-core backward's widths
# ---------------------------------------------------------------------------

BF16_STEP = 2.0 ** -8       # one bf16 rounding of the largest |grad|, at most
PADDED = {80: 128, 150: 192, 200: 256}


@pytest.mark.parametrize("dtype,hd,wide", [
    (torch.bfloat16, 1, 64), (torch.bfloat16, 16, 64), (torch.bfloat16, 64, 64),
    (torch.bfloat16, 65, 128), (torch.bfloat16, 80, 128),
    (torch.bfloat16, 129, 192), (torch.bfloat16, 150, 192),
    (torch.bfloat16, 192, 192), (torch.bfloat16, 193, 256),
    (torch.bfloat16, 256, 256), (torch.bfloat16, 257, 257),
    (torch.bfloat16, 576, 576), (torch.float32, 80, 80),
    (torch.float32, 192, 192)])
def test_flash_bwd_head_dim_by_route(dtype, hd, wide):
    """bf16 up to 256 runs at the next tensor-core width; the CUDA-core
    kernels (fp32, bf16 above 256) at hd itself."""
    assert FA.bwd_head_dim(hd, dtype) == wide


def _plain_bwd(q, k, v, out, lse, dout, causal, window, scale):
    return ref.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window, scale=scale,
                                   chunk=q.shape[1])


def _padded_bwd(backward, q, k, v, out, lse, dout, causal, window):
    """The backward wrapper's padding, ``FA._pad_call`` to ``bwd_head_dim``,
    around ``backward`` in the plain backward's argument order."""
    def run(q, k, v, out, dout, lse, causal, window, scale):
        return backward(q, k, v, out, lse, dout, causal, window, scale)

    return FA._pad_call(run, (q, k, v, out, dout),
                        FA.bwd_head_dim(q.shape[-1], q.dtype), lse, causal,
                        window)


def _wide_inputs(B, S, H, Kv, hd, seed, causal, window):
    """bf16 q, k, v, dout from numpy, and the plain forward's out and lse."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, S, n, hd).astype(np.float32))
                   .bfloat16() for n in (H, Kv, Kv, H))
    out, lse = ref.flash_attention(q, k, v, causal=causal, window=window,
                                   with_lse=True)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("hd", sorted(PADDED))
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bwd_padded_path_equals_unpadded_plain(hd, causal, window):
    """``_padded_bwd`` with the plain backward: it runs at the padded width
    with the true scale, and its dq, dk and dv are the unpadded plain
    backward's (the zero columns add exact zeros; fp32 sums over more
    columns may round one bf16 output step apart)."""
    args = _wide_inputs(2, 129, 8, 4, hd, hd, causal, window)
    seen = []

    def plain(*a):
        seen.append((a[0].shape[-1], a[-1]))
        return _plain_bwd(*a)

    got = _padded_bwd(plain, *args, causal, window)
    want = _plain_bwd(*args, causal, window, None)
    assert seen == [(PADDED[hd], 1.0 / math.sqrt(hd))]
    for g, w, t in zip(got, want, args):
        assert g.shape == w.shape == t.shape and g.dtype == torch.bfloat16
        assert g.is_contiguous()
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= BF16_STEP, err


def _padded_vs_jax(backward, hd, causal, window, seed):
    """``_padded_bwd(backward, ...)`` at the sweep's GQA shape, bf16 inputs
    from numpy, against JAX's ``_fa_bwd`` in fp32 on the same values: JAX's
    forward's lse and its out rounded to bf16 (as the port's forward stores
    it) go to both. The worst max|diff| / max|JAX| over dq, dk, dv."""
    rng = np.random.RandomState(seed)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _bf16(rng.randn(2, 129, n, hd).astype(np.float32))
        for n in (8, 4, 4, 8))
    jout, jlse, _ = _jax_fa_bwd(jq, jk, jv, jdo, causal, window)
    jout, tout = _bf16(np.asarray(jout))
    pos = jnp.broadcast_to(jnp.arange(129, dtype=jnp.int32)[None], (2, 129))
    res = (jq, jk, jv, pos, pos[0], jout, jlse)
    want = JL._fa_bwd(causal, window, 129, res, jdo)[:3]
    tlse = torch.from_numpy(np.array(jlse)).reshape(2, 8, 129)
    got = _padded_bwd(backward, tq, tk, tv, tout, tlse, tdo, causal,
                         window)
    return max(float(np.max(np.abs(g.float().numpy() - np.asarray(w))) /
                     np.max(np.abs(np.asarray(w)))) for g, w in zip(got, want))


@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bwd_padded_plain_matches_jax_at_200(causal, window):
    """The wrapper's path at hd 200 (run at 256) with the plain backward,
    against JAX: one bf16 rounding of the outputs apart."""
    err = _padded_vs_jax(_plain_bwd, 200, causal, window, seed=200)
    assert err <= BF16_STEP, err


@pytest.mark.parametrize("hd", sorted(PADDED))
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bwd_padded_tc_model_meets_the_gate(hd, causal, window):
    """The wrapper's path with the model of the tensor-core kernels' rounding
    at the padded width and the true scale, against JAX at the card's
    gate."""
    def model(q, k, v, out, lse, dout, causal, window, scale):
        return _tc_bwd_model(q, k, v, out, lse, dout, causal, window, scale)

    err = _padded_vs_jax(model, hd, causal, window, seed=hd + 1)
    assert err <= GRAD_GATE, err


# ---------------------------------------------------------------------------
# (e), (f) LSTM backpropagation through time against jax.grad
# ---------------------------------------------------------------------------

def _jax_scan_grads(x, h0, c0, w, b, r):
    """jax.grad of sum(hs * r) over the reference cell's lax.scan
    (``repro/models/lstm.py:68``'s step) with a zero e_t added to each z:
    (dz [T,B,4H] = d/de, dh0, dc0)."""
    H = h0.shape[1]

    def loss(h0, c0, e):
        def step(hc, xe):
            h, c = hc
            x_t, e_t = xe
            z = jnp.concatenate([x_t, h], -1) @ w + b + e_t
            i, f, g, o = (z[:, n * H:(n + 1) * H] for n in range(4))
            c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
            h = jax.nn.sigmoid(o) * jnp.tanh(c)
            return (h, c), h
        _, hs = jax.lax.scan(step, (h0, c0), (x, e))
        return jnp.sum(hs * r)

    e = jnp.zeros((x.shape[0], x.shape[1], 4 * H), jnp.float32)
    dh0, dc0, dz = jax.grad(loss, argnums=(0, 1, 2))(h0, c0, e)
    return dz, dh0, dc0


def _fma32(a, x, y):
    """fp32 a + x * y with one rounding of the product and sum (computed in
    fp64, where the product of two fp32 values is exact)."""
    return (a.double() + x.double() * y.double()).float()


def _bptt_kernel_model(dhs, gates, cs, c0, w_h):
    """lstm_seq_bwd_kernel's arithmetic on the CPU: every fp32 operation in
    the kernel's order (``__fmul_rn`` / ``__fadd_rn`` round each step), and
    dh_next[j] summed as the kernel does: lane (j, g) runs an fmaf chain
    over u = 0 .. H-1 of dz[g*H + u] * W_h[j, g*H + u], the quad adds the
    four as (p0 + p1) + (p2 + p3)."""
    T, B, H = dhs.shape
    f32 = torch.float32
    dz = torch.empty(T, B, 4 * H, dtype=f32)
    dh_next = torch.zeros(B, H, dtype=f32)
    dc = torch.zeros(B, H, dtype=f32)
    w = w_h.to(f32).reshape(H, 4, H)                      # [j, g, u]
    for t in range(T - 1, -1, -1):
        gi, gf, gg, go = gates[t].split(H, -1)
        ct = cs[t].to(f32)
        cp = (cs[t - 1] if t > 0 else c0).to(f32)
        dh = dhs[t].to(f32) + dh_next
        tc = torch.tanh(ct)
        dc = dc + dh * (go * (1 - tc * tc))
        dz[t] = torch.cat([gg * gi * (1 - gi) * dc, cp * gf * (1 - gf) * dc,
                           gi * (1 - gg * gg) * dc, tc * go * (1 - go) * dh],
                          -1)
        dc = dc * gf
        z = dz[t].reshape(B, 4, H)                        # [b, g, u]
        part = torch.zeros(B, H, 4, dtype=f32)            # [b, j, g]
        for u in range(H):
            part = _fma32(part, z[:, None, :, u], w[None, :, :, u])
        dh_next = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
    return dz, dh_next, dc


@pytest.mark.parametrize("bwd", ["plain", "kernel_model"])
@pytest.mark.parametrize("T,B,Din,H", [(8, 1, 7, 5), (10, 8, 95, 50),
                                       (6, 3, 33, 20), (40, 8, 50, 50)])
def test_lstm_bptt_matches_jax_grad(bwd, T, B, Din, H):
    x, h0, c0, w, b, hs, cs, gates = _seq_state(T, B, Din, H, seed=Din + H)
    r = np.random.RandomState(B).randn(T, B, H).astype(np.float32)
    fn = ref.lstm_seq_bwd if bwd == "plain" else _bptt_kernel_model
    got = fn(torch.from_numpy(r), gates, cs, c0, w[Din:])
    want = _jax_scan_grads(*(jnp.asarray(t.numpy()) for t in
                             (x, h0, c0, w, b)), r)
    for name, g, wj in zip(("dz", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wj),
                                   rtol=TOL["float32"], atol=TOL["float32"],
                                   err_msg=name)


def test_lstm_bptt_kernel_model_is_not_the_plain_order():
    """The model sums dh_next in the kernel's order, not cuBLAS's or the
    CPU's: at the paper's width some dz differs from the plain version's in
    the last bits (so the agreement above is of two orders, not one)."""
    x, h0, c0, w, b, hs, cs, gates = _seq_state(40, 8, 95, 50, seed=4)
    dhs = torch.from_numpy(np.random.RandomState(5).randn(40, 8, 50)
                           .astype(np.float32))
    got = _bptt_kernel_model(dhs, gates, cs, c0, w[95:])[0]
    want = ref.lstm_seq_bwd(dhs, gates, cs, c0, w[95:])[0]
    assert not torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=TOL["float32"],
                               atol=TOL["float32"])


# ---------------------------------------------------------------------------
# (g) the autograd Functions reach the ops names
# ---------------------------------------------------------------------------

def test_seq_backward_calls_ops_lstm_seq_bwd_by_name(monkeypatch):
    calls = []

    def counting(*args):
        calls.append(tuple(a.shape for a in args))
        return ref.lstm_seq_bwd(*args)

    monkeypatch.setattr(ops, "lstm_seq_bwd", counting)
    x, h0, c0, w, b, *_ = _seq_state(6, 2, 7, 5, seed=6)
    leaves = [t.clone().requires_grad_() for t in (x, h0, c0, w, b)]
    hs = TLSTM._Seq.apply(*leaves)
    hs.sum().backward()
    assert calls == [((6, 2, 5), (6, 2, 20), (6, 2, 5), (2, 5), (5, 20))]
    # a patch that answers zeros zeroes every gradient: the name is taken
    monkeypatch.setattr(ops, "lstm_seq_bwd",
                        lambda dhs, gates, cs, c0, w_h: (
                            torch.zeros_like(gates), torch.zeros_like(c0),
                            torch.zeros_like(c0)))
    grads = torch.autograd.grad(TLSTM._Seq.apply(*leaves).sum(), leaves)
    assert all(not g.any() for g in grads)


def test_lstm_model_backward_runs_one_bptt_call_a_layer(monkeypatch):
    from repro_torch.configs.paper_lstm import CONFIG
    calls = []
    plain = ops.lstm_seq_bwd
    monkeypatch.setattr(ops, "lstm_seq_bwd",
                        lambda *a: calls.append(1) or plain(*a))
    params = TLSTM.init_lstm_model(torch.Generator().manual_seed(0),
                                   CONFIG.replace(d_model=8), 11, "cpu")
    batch = {"x": torch.eye(11)[torch.randint(0, 11, (3, 5))],
             "y": torch.tensor([1, 2, 3])}
    leaves = [lp["kernel"].requires_grad_() for lp in params["layers"]]
    torch.autograd.grad(TLSTM.lstm_loss(params, batch), leaves)
    assert len(calls) == CONFIG.n_layers


def test_flash_backward_calls_ops_flash_attention_bwd_by_name(monkeypatch):
    calls = []

    def counting(q, k, v, out, lse, dout, **kw):
        calls.append(kw)
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)

    monkeypatch.setattr(ops, "flash_attention_bwd", counting)
    q, k, v, _, _, do = _fa_inputs(1, 30, 4, 2, 16, seed=7)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.attention(*leaves, causal=True, window=9)
    got = torch.autograd.grad(out, leaves, do)
    assert calls == [dict(causal=True, window=9, chunk=30)]
    o, lse = ref.flash_attention(q, k, v, window=9, with_lse=True)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, window=9, chunk=30)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
