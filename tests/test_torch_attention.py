"""The port's rmsnorm and flash_attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX runs
at ``highest`` matmul precision (``tests/conftest.py``). The plain versions
are held to the JAX oracles (``repro/kernels/ref.py``) over the sweeps of
``tests/test_kernels.py``, and to the Pallas kernels in interpret mode on a
few cases (the JAX package's own tests hold Pallas against its oracles over
the whole sweep). The CUDA kernels run only on the card (``chip_smoke.py``);
here the dispatch sends CPU tensors to the plain versions and the wrappers
refuse what their kernels do not take.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
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


@pytest.mark.parametrize("bad,why", [("cpu", "not a CUDA device"),
                                     ("seq", "Sq == Skv"),
                                     ("groups", "not a positive multiple"),
                                     ("head_dim", "head dim 48"),
                                     ("dtype", "v is torch.bfloat16"),
                                     ("strided", "k is not contiguous"),
                                     ("window", "window -1")])
def test_flash_wrapper_raises(bad, why):
    q, k, v = torch.ones(1, 8, 4, 16), torch.ones(1, 8, 2, 16), \
        torch.ones(1, 8, 2, 16)
    window = 0
    if bad == "seq":
        q = torch.ones(1, 6, 4, 16)
    elif bad == "groups":
        k = v = torch.ones(1, 8, 3, 16)
    elif bad == "head_dim":
        q, k, v = (torch.ones(1, 8, n, 48) for n in (4, 2, 2))
    elif bad == "dtype":
        v = v.bfloat16()
    elif bad == "strided":
        k = torch.ones(1, 2, 8, 16).transpose(1, 2)
    elif bad == "window":
        window = -1
    before = FA.flash_attention.launches
    with pytest.raises(ValueError, match=why):
        FA.flash_attention(q, k, v, window=window)
    assert FA.flash_attention.launches == before
