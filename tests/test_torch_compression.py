"""The port's gradient codecs and ternary kernels' plain versions against the
JAX package, on the CPU.

Every input is made with numpy from a seed and handed to both packages. The
codecs are exact (a threshold, a sign, a copy of kept values), so every
comparison here is bit for bit: the packed bytes, the decoded gradients, the
error-feedback residuals and the byte counts. The CUDA kernels themselves run
only on the card (``chip_smoke.py`` holds them against these plain versions
there); here the dispatch sends CPU tensors to the plain versions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.optim import compression as JC
from repro_torch import tree
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ternary as T
from repro_torch.optim import compression as TC

# tests/test_kernels.py::test_ternary_kernel_roundtrip's sweep, and the six
# leaves of the paper's gradient padded to a multiple of 4 (head b 95 -> 96,
# head w 4,750 -> 4,752)
SWEEP = [4, 128, 4096, 10000]
PAPER_PADDED = [96, 4752, 200, 29000, 20000]
PAPER_SHAPES = {"head": {"b": (95,), "w": (50, 95)},
                "layers": [{"bias": (200,), "kernel": (145, 200)},
                           {"bias": (200,), "kernel": (100, 200)}]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These shapes are tiny: one intra-op thread is as fast, and it leaves
    the other cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    """fp32 array as its bit patterns (+0.0 and -0.0 differ)."""
    return np.asarray(x, np.float32).view(np.int32)


def _paper_tree(seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.randn(*s).astype(np.float32),
                        PAPER_SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(t):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def _np_leaves(t):
    return [np.asarray(x) for x in jax.tree.leaves(t)]


# ---------------------------------------------------------------------------
# (a) the kernels' plain versions against the Pallas kernels and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SWEEP + PAPER_PADDED)
def test_plain_ternary_matches_jax_kernel(n):
    g = np.random.RandomState(n).randn(n).astype(np.float32)
    s = np.float32(np.abs(g).max())
    gj, sj = jnp.asarray(g), jnp.asarray(s)
    gt, st = torch.from_numpy(g), torch.tensor(s)

    packed_j = np.asarray(jops.ternary_encode(gj, sj, interpret=True))
    dec_j = np.asarray(jops.ternary_decode(jnp.asarray(packed_j), sj,
                                           interpret=True))
    t_j = np.asarray(jref.ternary_encode(gj, sj))

    packed_t = ops.ternary_encode(gt, st)
    assert packed_t.dtype == torch.uint8 and packed_t.shape == (n // 4,)
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    t_t = ref.ternary_encode(gt, st)
    assert t_t.dtype == torch.int8
    np.testing.assert_array_equal(t_t.numpy(), t_j)
    np.testing.assert_array_equal(ref.ternary_pack(t_t).numpy(),
                                  np.asarray(jref.ternary_pack(
                                      jnp.asarray(t_j))))
    np.testing.assert_array_equal(ref.ternary_unpack(packed_t, n).numpy(),
                                  np.asarray(jref.ternary_unpack(
                                      jnp.asarray(packed_j), n)))
    dec_t = ops.ternary_decode(packed_t, st)
    assert dec_t.dtype == torch.float32 and dec_t.shape == (n,)
    np.testing.assert_array_equal(_bits(dec_t.numpy()), _bits(dec_j))


def test_plain_decode_of_every_byte_matches_pallas():
    """All 256 byte values, the unused code 0b11 included, decode as the
    Pallas body decodes them."""
    every = np.arange(256, dtype=np.uint8)
    s = np.float32(0.37)
    want = jops.ternary_decode(jnp.asarray(every), jnp.asarray(s),
                               interpret=True)
    got = ops.ternary_decode(torch.from_numpy(every), torch.tensor(s))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# ---------------------------------------------------------------------------
# (b) the threshold: the JAX codec tests |g|/s >= 0.5, the kernel |g| >= s/2
# ---------------------------------------------------------------------------

def _edge_leaf(s):
    """s itself (the max), s/2, its two float neighbours, their negatives,
    and a spread of values below s."""
    s = np.float32(s)
    half = np.float32(s / 2)
    edge = [half, np.nextafter(half, np.float32(0)),
            np.nextafter(half, np.float32(np.inf))]
    rng = np.random.RandomState(int(np.log2(s) * 8) % 1000)
    spread = (rng.uniform(-1, 1, 9) * s * np.float32(0.999)).astype(np.float32)
    return np.array([s, *edge, *(-e for e in edge), *spread], np.float32)


@pytest.mark.parametrize("s", [1.0, 2.0, 0.5, 2.0 ** -20, 2.0 ** 40,
                               1.7, 3.14159e-3, 123.456, 6.02e23, 1e-30])
def test_threshold_boundary_matches_jax_codec(s):
    g = {"w": _edge_leaf(s)}
    jp, jn = JC.ternary_encode(_to_jax(g))
    tp, tn = TC.ternary_encode(_to_torch(g))
    assert tn == jn
    np.testing.assert_array_equal(
        ref.ternary_unpack(tp["w"]["packed"], g["w"].size).numpy(),
        np.asarray(jp["w"]["t"]))
    np.testing.assert_array_equal(_bits(TC.ternary_decode(tp)["w"].numpy()),
                                  _bits(JC.ternary_decode(jp)["w"]))


def test_threshold_agrees_over_sixty_decades():
    """One leaf per scale, 400 scales drawn over 1e-30..1e30, each leaf
    carrying s/2 and its neighbours: the port's codec (|g| >= s/2) and the
    JAX codec (|g|/s >= 0.5) keep the same entries."""
    rng = np.random.RandomState(0)
    scales = (10.0 ** rng.uniform(-30, 30, 400)).astype(np.float32)
    g = {f"l{i:03d}": _edge_leaf(s) for i, s in enumerate(scales)}
    jp, _ = JC.ternary_encode(_to_jax(g))
    tp, _ = TC.ternary_encode(_to_torch(g))
    for k in g:
        np.testing.assert_array_equal(
            ref.ternary_unpack(tp[k]["packed"], g[k].size).numpy(),
            np.asarray(jp[k]["t"]), err_msg=k)


# ---------------------------------------------------------------------------
# (c) codecs and error feedback on the paper's six leaf shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["none", "topk", "ternary"])
def test_codec_round_trip_matches_jax(name):
    g = _paper_tree(1)
    jc, tc = JC.make_codec(name), TC.make_codec(name)
    jp, jn = jc.encode(_to_jax(g))
    tp, tn = tc.encode(_to_torch(g))
    assert tn == jn
    for a, b in zip(_np_leaves(jc.decode(jp)),
                    tree.leaves(tc.decode(tp)), strict=True):
        assert b.dtype == torch.float32 and b.shape == a.shape
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


def test_ternary_nbytes_of_the_paper_gradient():
    _, nbytes = TC.ternary_encode(_to_torch(_paper_tree(2)))
    assert nbytes == 13_586              # sum of ceil(n/4) + 4 over 6 leaves
    assert TC.dense_bytes(_to_torch(_paper_tree(2))) == 216_980


@pytest.mark.parametrize("name,kw", [("none", {}), ("topk", {}),
                                     ("topk", {"fraction": 0.05}),
                                     ("ternary", {})])
def test_ef_compress_chain_matches_jax(name, kw):
    """Three chained error-feedback steps from the same gradients: decoded
    gradients, residuals and byte counts equal JAX's bit for bit."""
    jc, tc = JC.make_codec(name, **kw), TC.make_codec(name, **kw)
    g0 = _paper_tree(10)
    jr, tr = JC.ef_init(_to_jax(g0)), TC.ef_init(_to_torch(g0))
    for step in range(3):
        g = _paper_tree(10 + step)
        jd, jr, jn = JC.ef_compress(jc, _to_jax(g), jr)
        td, tr, tn = TC.ef_compress(tc, _to_torch(g), tr)
        assert tn == jn, step
        for a, b in zip(_np_leaves((jd, jr)), tree.leaves((td, tr)),
                        strict=True):
            np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))


def test_make_codec_names():
    assert TC.make_codec("none").name == JC.make_codec("none").name == "none"
    assert TC.make_codec("topk").name == JC.make_codec("topk").name \
        == "topk(0.01)"
    assert TC.make_codec("topk", fraction=0.05).name == "topk(0.05)"
    assert TC.make_codec("ternary").name == "ternary"
    with pytest.raises(KeyError):
        TC.make_codec("terngrad")


def test_error_feedback_reduces_bias():
    """With EF, the accumulated compressed signal tracks the true sum
    (``tests/test_compression.py::test_error_feedback_reduces_bias``)."""
    T_STEPS = 60
    codec = TC.make_codec("topk", fraction=0.1)
    g_true = {"w": torch.from_numpy(
        np.random.RandomState(0).randn(200).astype(np.float32))}
    residual = TC.ef_init(g_true)
    acc, acc_noef = torch.zeros(200), torch.zeros(200)
    for _ in range(T_STEPS):
        dec, residual, _ = TC.ef_compress(codec, g_true, residual)
        acc = acc + dec["w"]
        acc_noef = acc_noef + TC.topk_decode(
            TC.topk_encode(g_true, 0.1)[0])["w"]
    target = T_STEPS * g_true["w"]
    rel = float(torch.linalg.norm(acc - target) / torch.linalg.norm(target))
    rel_noef = float(torch.linalg.norm(acc_noef - target)
                     / torch.linalg.norm(target))
    assert rel < 0.2, rel
    assert rel < rel_noef / 3, (rel, rel_noef)


def test_ternary_error_feedback_reduces_bias():
    T_STEPS = 60
    codec = TC.make_codec("ternary")
    g_true = {"w": torch.from_numpy(
        np.random.RandomState(1).randn(333).astype(np.float32))}
    residual = TC.ef_init(g_true)
    acc = torch.zeros(333)
    for _ in range(T_STEPS):
        dec, residual, _ = TC.ef_compress(codec, g_true, residual)
        acc = acc + dec["w"]
    no_ef = T_STEPS * TC.ternary_decode(TC.ternary_encode(g_true)[0])["w"]
    target = T_STEPS * g_true["w"]
    rel = float(torch.linalg.norm(acc - target) / torch.linalg.norm(target))
    rel_noef = float(torch.linalg.norm(no_ef - target)
                     / torch.linalg.norm(target))
    assert rel < 0.1, rel
    assert rel < rel_noef / 3, (rel, rel_noef)


# ---------------------------------------------------------------------------
# (d) the stochastic variant: properties only (jax.random's bits are not
# reproducible in PyTorch)
# ---------------------------------------------------------------------------

def test_stochastic_ternary_is_seeded_and_unbiased():
    g = {"w": torch.from_numpy(
        np.random.RandomState(2).randn(50).astype(np.float32))}
    a, na = TC.ternary_encode(g, torch.Generator().manual_seed(5))
    b, nb = TC.ternary_encode(g, torch.Generator().manual_seed(5))
    c, _ = TC.ternary_encode(g, torch.Generator().manual_seed(6))
    assert na == nb == TC.ternary_encode(g)[1]
    assert torch.equal(a["w"]["packed"], b["w"]["packed"])
    assert not torch.equal(a["w"]["packed"], c["w"]["packed"])

    s = g["w"].abs().max()
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([TC.ternary_decode(TC.ternary_encode(g, gen)[0])["w"]
                         for _ in range(4000)])
    levels = torch.unique(draws.abs())
    assert all(torch.isclose(v, s) or v == 0 for v in levels)
    # E[decoded] = s * sign(g) * |g|/s = g; the standard error of a mean of
    # 4000 draws of a value in [-s, s] is at most s / sqrt(4000) ~ 0.016 s
    err = (draws.mean(0) - g["w"]).abs().max()
    assert err < 0.07 * s, (float(err), float(s))


# ---------------------------------------------------------------------------
# (e) dispatch and the CUDA wrappers' refusals (before any build or launch)
# ---------------------------------------------------------------------------

def test_ops_dispatch_cpu_goes_to_plain_version():
    g = torch.from_numpy(np.random.RandomState(3).randn(64).astype(np.float32))
    s = g.abs().max()
    before = (T.ternary_encode.launches, T.ternary_decode.launches)
    packed = ops.ternary_encode(g, s)
    assert torch.equal(packed, ref.ternary_encode_packed(g, s))
    assert torch.equal(ops.ternary_decode(packed, s),
                       ref.ternary_decode_packed(packed, s))
    assert (T.ternary_encode.launches, T.ternary_decode.launches) == before
    with pytest.raises(ValueError, match="not a multiple of 4"):
        ops.ternary_encode(g[:6], s)


@pytest.mark.parametrize("fn,bad,why", [
    ("encode", "cpu", "not a CUDA device"),
    ("decode", "cpu", "not a CUDA device"),
    ("encode", "n%4", "not a multiple of 4"),
    ("encode", "dtype", "input is torch.float64"),
    ("decode", "dtype", "input is torch.float32, want torch.uint8"),
    ("encode", "scale", "scale must be one float32 value"),
    ("encode", "2d", "must be 1-D and contiguous"),
    ("decode", "empty", "0 elements"),
])
def test_cuda_wrapper_raises(fn, bad, why):
    g = torch.from_numpy(np.random.RandomState(4).randn(16).astype(np.float32))
    s = g.abs().max()
    x = g if fn == "encode" else ref.ternary_encode_packed(g, s)
    if bad == "n%4":
        x = g[:6]
    elif bad == "dtype":
        x = x.double() if fn == "encode" else g
    elif bad == "scale":
        s = torch.stack([s, s])
    elif bad == "2d":
        x = g.reshape(4, 4)
    elif bad == "empty":
        x = x[:0]
    wrapper = T.ternary_encode if fn == "encode" else T.ternary_decode
    before = wrapper.launches
    with pytest.raises(ValueError, match=why):
        wrapper(x, s)
    assert wrapper.launches == before
