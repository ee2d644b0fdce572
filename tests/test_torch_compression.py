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


# ---------------------------------------------------------------------------
# (f) a leaf whose scale is not finite: NaN where the JAX codec gives NaN
# ---------------------------------------------------------------------------

def _nan_equal(got, want):
    """Equal bit for bit, except that any NaN matches any NaN (the card's
    canonical NaN is not the CPU's)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(got[ok]), _bits(want[ok]))


NON_FINITE = {"inf": [1, -0.3, np.inf, 0.2, 0.9],
              "-inf": [1, -0.3, -np.inf, 0.2, 0.9],
              "nan": [1, -0.3, np.nan, 0.2, 0.9],
              "inf_nan": [np.nan, np.inf, -2.0, 0.0]}


@pytest.mark.parametrize("case", list(NON_FINITE))
def test_non_finite_leaf_matches_jax_codec(case):
    """A leaf holding inf or NaN has a scale of inf or NaN: the JAX codec
    keeps no code there and decodes every value to 0 * s = NaN; so does the
    port, and the other leaves are untouched, bit for bit."""
    g = {"bad": np.array(NON_FINITE[case], np.float32),
         "ok": np.random.RandomState(7).randn(3, 5).astype(np.float32)}
    jp, jn = JC.ternary_encode(_to_jax(g))
    tp, tn = TC.ternary_encode(_to_torch(g))
    assert tn == jn
    for k in g:
        np.testing.assert_array_equal(
            tp[k]["packed"].numpy(),
            jref.ternary_pack(jnp.asarray(np.pad(
                np.asarray(jp[k]["t"]).reshape(-1),
                (0, -g[k].size % 4)))))
        _nan_equal(tp[k]["s"].numpy(), jp[k]["s"])
    jd, td = JC.ternary_decode(jp), TC.ternary_decode(tp)
    for k in g:
        _nan_equal(td[k].numpy(), jd[k])
    assert np.isnan(td["bad"].numpy()).all()


@pytest.mark.parametrize("case", list(NON_FINITE))
def test_non_finite_ef_compress_matches_jax(case):
    """Error feedback through a non-finite leaf: decoded gradient and
    residual as the JAX codec's (NaN as NaN), over two chained steps."""
    g = {"bad": np.array(NON_FINITE[case], np.float32),
         "ok": np.random.RandomState(8).randn(7).astype(np.float32)}
    jc, tc = JC.make_codec("ternary"), TC.make_codec("ternary")
    jr, tr = JC.ef_init(_to_jax(g)), TC.ef_init(_to_torch(g))
    for _ in range(2):
        jd, jr, jn = JC.ef_compress(jc, _to_jax(g), jr)
        td, tr, tn = TC.ef_compress(tc, _to_torch(g), tr)
        assert tn == jn
        for a, b in zip(_np_leaves((jd, jr)), tree.leaves((td, tr)),
                        strict=True):
            _nan_equal(b.numpy(), a)


@pytest.mark.parametrize("s", [np.inf, np.nan])
def test_plain_decode_at_non_finite_scale_matches_pallas(s):
    """All 256 byte values at s = inf and NaN: every code, 0b00 included,
    decodes to val * s, as the Pallas body computes it."""
    every = np.arange(256, dtype=np.uint8)
    want = jops.ternary_decode(jnp.asarray(every), jnp.asarray(np.float32(s)),
                               interpret=True)
    got = ops.ternary_decode(torch.from_numpy(every),
                             torch.tensor(s, dtype=torch.float32))
    _nan_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (g) the gradient-level codec: plain versions, leaf table, refusals
# ---------------------------------------------------------------------------

RANDOM_TREE_SIZES = [1, 3, 4, 5, 4750]


def _random_tree(seed):
    """Leaves of 1, 3, 4, 5 and 4,750 elements in shuffled order and
    scales, one of them all zeros."""
    rng = np.random.RandomState(seed)
    sizes = list(rng.permutation(RANDOM_TREE_SIZES))
    leaves = [(rng.randn(n) * 10.0 ** rng.uniform(-8, 8)).astype(np.float32)
              for n in sizes]
    leaves[seed % len(leaves)][:] = 0.0
    return {"a": leaves[0], "b": [leaves[1], leaves[2]],
            "c": {"x": leaves[3].reshape(-1, 1), "y": leaves[4]}}


def _per_leaf_chain(gs, rs):
    """Error feedback leaf by leaf through the single-leaf plain versions
    (the per-leaf chain the codec ran before the gradient-level pass)."""
    out = []
    for g, r in zip(gs, rs):
        c = g + r
        n = c.numel()
        s = torch.clamp_min(c.abs().max(), 1e-12)
        padded = torch.cat([c, c.new_zeros(-n % 4)])
        packed = ref.ternary_encode_packed(padded, s)
        d = ref.ternary_decode_packed(packed, s)[:n]
        out.append((packed, s, d, c - d))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", ["paper", "random"])
def test_gradient_level_plain_matches_jax_and_per_leaf_chain(seed, shape):
    """``ref.ternary_ef`` (the gradient-level pass's plain version) against
    the JAX codec's encode, decode and residual and against the per-leaf
    chain of the single-leaf plain versions, bit for bit: packed bytes,
    scales, decoded gradient and residual."""
    g = _paper_tree(20 + seed) if shape == "paper" else _random_tree(seed)
    r = _paper_tree(40 + seed) if shape == "paper" else jax.tree.map(
        lambda a: (np.random.RandomState(a.size).randn(*a.shape) *
                   (np.abs(a).max() + 1e-3)).astype(np.float32), g)
    gs = [torch.from_numpy(a.reshape(-1)) for a in _np_leaves(g)]
    rs = [torch.from_numpy(a.reshape(-1)) for a in _np_leaves(r)]
    packed, s, dec, res = ref.ternary_ef(gs, rs, payload=True)
    jd, jr, _ = JC.ef_compress(JC.make_codec("ternary"), _to_jax(g),
                               _to_jax(r))
    jp, _ = JC.ternary_encode(jax.tree.map(lambda a, b: a + b, _to_jax(g),
                                           _to_jax(r)))
    jps = jax.tree.leaves(jp, is_leaf=JC._is_payload)
    chain = _per_leaf_chain(gs, rs)
    for i, (a_d, a_r, p) in enumerate(zip(_np_leaves(jd), _np_leaves(jr),
                                          jps, strict=True)):
        t = np.asarray(p["t"]).reshape(-1)
        np.testing.assert_array_equal(
            packed[i].numpy(),
            jref.ternary_pack(jnp.asarray(np.pad(t, (0, -t.size % 4)))))
        np.testing.assert_array_equal(_bits(s[i].numpy()), _bits(p["s"]))
        np.testing.assert_array_equal(_bits(dec[i].numpy()),
                                      _bits(a_d.reshape(-1)))
        np.testing.assert_array_equal(_bits(res[i].numpy()),
                                      _bits(a_r.reshape(-1)))
        for got, want in zip((packed[i], s[i], dec[i], res[i]), chain[i]):
            assert torch.equal(got.view(torch.uint8) if got.dtype ==
                               torch.uint8 else got.view(torch.int32),
                               want.view(torch.uint8) if want.dtype ==
                               torch.uint8 else want.view(torch.int32))


@pytest.mark.parametrize("shape", ["paper", "random"])
def test_gradient_level_encode_decode_plain_match_jax(shape):
    """``ref.ternary_encode_leaves`` / ``ternary_decode_leaves`` (the
    gradient-level encode and decode) against the JAX codec bit for bit,
    with scales found and with the JAX codec's scales given."""
    g = _paper_tree(3) if shape == "paper" else _random_tree(5)
    gs = [torch.from_numpy(a.reshape(-1)) for a in _np_leaves(g)]
    jp, _ = JC.ternary_encode(_to_jax(g))
    jps = jax.tree.leaves(jp, is_leaf=JC._is_payload)
    jd = _np_leaves(JC.ternary_decode(jp))
    given = [torch.from_numpy(np.array(p["s"])) for p in jps]
    for scales in (None, given):
        packed, s = ref.ternary_encode_leaves(gs, scales)
        dec = ref.ternary_decode_leaves(packed, s, [x.shape for x in gs])
        for i, p in enumerate(jps):
            t = np.asarray(p["t"]).reshape(-1)
            np.testing.assert_array_equal(
                packed[i].numpy(),
                jref.ternary_pack(jnp.asarray(np.pad(t, (0, -t.size % 4)))))
            np.testing.assert_array_equal(_bits(s[i].numpy()),
                                          _bits(p["s"]))
            np.testing.assert_array_equal(_bits(dec[i].numpy()),
                                          _bits(jd[i].reshape(-1)))


def test_ef_compress_takes_the_gradient_level_pass():
    """The ternary codec's error feedback goes through ``ops.ternary_ef``
    once per gradient (not encode, then decode)."""
    from unittest import mock
    g = _to_torch(_paper_tree(4))
    codec = TC.make_codec("ternary")
    assert codec.ef is not None and TC.make_codec("topk").ef is None
    with mock.patch.object(ops, "ternary_ef", wraps=ops.ternary_ef) as ef, \
            mock.patch.object(ops, "ternary_encode_leaves") as enc:
        TC.ef_compress(codec, g, TC.ef_init(g))
    assert ef.call_count == 1 and enc.call_count == 0
    assert [tuple(x.shape) for x in ef.call_args[0][0]] == \
        [(95,), (50, 95), (200,), (145, 200), (200,), (100, 200)]


def test_leaf_table_of_the_paper_gradient():
    """Offsets into the padded concatenation (each leaf padded to 16
    elements), byte offsets, blocks and spans of the paper's 6 leaves."""
    tab = T.leaf_table((95, 4750, 200, 29000, 200, 20000))
    assert tab.offsets == (0, 96, 4848, 5056, 34064, 34272)
    assert tab.total == 54272 and all(o % 16 == 0 for o in tab.offsets)
    assert tab.nblocks == (1, 2, 1, 8, 1, 5)
    assert tab.block0 == (0, 1, 3, 4, 12, 13) and tab.n_blocks == 18
    assert tab.spans == (1024, 3072, 1024, 4096, 1024, 4096)
    assert len(tab.groups) == 1 and len(tab.groups[0].table.leaf) == 64
    leaf = tab.groups[0].table.leaf[3]
    assert (leaf.n, leaf.off, leaf.block0, leaf.nblocks, leaf.span) == \
        (29000, 5056, 4, 8, 4096)
    # each leaf's packed view is exactly ceil(n/4) bytes of the stream, at
    # byte offset off / 4
    stream = torch.arange(tab.total // 4, dtype=torch.int32)
    views = tab.views(stream, unit=0.25)
    assert [v.numel() for v in views] == [24, 1188, 50, 7250, 50, 5000]
    assert [int(v[0]) for v in views] == [o // 4 for o in tab.offsets]
    fp32 = tab.views(torch.arange(2 * tab.total), base=tab.total)
    assert [int(v[0]) for v in fp32] == [tab.total + o for o in tab.offsets]
    assert [v.numel() for v in fp32] == [95, 4750, 200, 29000, 200, 20000]
    shaped = tab.views(torch.arange(tab.total), [(95,), (50, 95), (200,),
                                                 (145, 200), (200,),
                                                 (100, 200)])
    assert shaped[1].shape == (50, 95) and shaped[1].is_contiguous()
    assert int(shaped[3][1, 0]) == 5056 + 200


@pytest.mark.parametrize("sizes", [(2 ** 26,), (2 ** 20,) * 64, (1,) * 70,
                                   tuple(RANDOM_TREE_SIZES)])
def test_leaf_table_blocks_cover_every_leaf(sizes):
    """Every leaf's blocks cover its padded span, 1 to 1,024 blocks of a
    multiple of 1,024 elements; more than 64 leaves take more launches."""
    tab = T.leaf_table(sizes)
    for n, nb, span in zip(tab.sizes, tab.nblocks, tab.spans):
        padded = -(-n // 16) * 16
        assert 1 <= nb <= 1024 and span % 1024 == 0
        assert (nb - 1) * span < padded <= nb * span
    assert len(tab.groups) == -(-len(sizes) // 64)
    assert sum(g.blocks for g in tab.groups) == tab.n_blocks
    for g in tab.groups:
        assert g.table.n_leaves == g.count <= len(g.table.leaf)
    if sizes == (2 ** 26,):
        assert tab.nblocks == (1024,) and tab.spans == (65536,)


@pytest.mark.parametrize("fn,bad,why", [
    ("ef", "cpu", "not a CUDA device"),
    ("ef", "empty_list", "non-empty list"),
    ("ef", "count", "holds 1 leaves, want 2"),
    ("ef", "size", "holds 3 elements, want 4"),
    ("ef", "dtype", "is torch.float64"),
    ("ef", "strided", "must be contiguous"),
    ("encode", "cpu", "not a CUDA device"),
    ("encode", "scale", "holds 2 elements, want 1"),
    ("decode", "cpu", "not a CUDA device"),
    ("decode", "bytes", "holds 2 elements, want 1"),
    ("decode", "dtype", "want torch.uint8"),
])
def test_gradient_level_wrappers_raise(fn, bad, why):
    """The gradient-level wrappers refuse, before any build or launch, what
    their kernels do not take."""
    gs = [torch.ones(4), torch.ones(7)]
    rs = [torch.zeros(4), torch.zeros(7)]
    scales = [torch.tensor(1.0), torch.tensor(1.0)]
    packed = [torch.zeros(1, dtype=torch.uint8),
              torch.zeros(2, dtype=torch.uint8)]
    sizes = [4, 7]
    if bad == "empty_list":
        gs = []
    elif bad == "count":
        rs = rs[:1]
    elif bad == "size":
        rs = [torch.zeros(3), rs[1]]
    elif bad == "dtype":
        gs = [gs[0].double(), gs[1]]
        packed = [packed[0].float(), packed[1]]
    elif bad == "strided":
        gs = [torch.ones(2, 2).t(), gs[1]]
    elif bad == "scale":
        scales = [torch.ones(2), scales[1]]
    elif bad == "bytes":
        packed = [torch.zeros(2, dtype=torch.uint8), packed[1]]
    counts = (T.ternary_encode.launches, T.ternary_decode.launches,
              T.ef_compress_leaves.launches)
    with pytest.raises(ValueError, match=why):
        if fn == "ef":
            T.ef_compress_leaves(gs, rs)
        elif fn == "encode":
            T.encode_leaves(gs, scales)
        else:
            T.decode_leaves(packed, scales, [(n,) for n in sizes])
    assert counts == (T.ternary_encode.launches, T.ternary_decode.launches,
                      T.ef_compress_leaves.launches)
