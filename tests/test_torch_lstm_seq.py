"""The port's whole-sequence LSTM layer against the JAX package, on the CPU.

``kernels/ref.py::lstm_seq`` (the plain version of the sequence kernel) is
held to a ``lax.scan`` over the JAX oracle ``repro/kernels/ref.py::
lstm_cell`` and, on one shape, over the Pallas kernel in interpret mode.
``models/lstm.py::_Seq``'s backpropagation through time is held to
``jax.grad`` of the same scan and to torch autograd through the per-step
plain path. Inputs are made with numpy from a seed and handed to both
packages; JAX runs at ``highest`` matmul precision (``tests/conftest.py``).
The CUDA kernel runs only on the card (``chip_smoke.py``); here the dispatch
sends CPU tensors to the plain version and the wrapper refuses them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import lstm_cell as K
from repro_torch.kernels import ops, ref
from repro_torch.models import lstm as TLSTM

# tests/test_kernels.py::_tol — fp32 2e-5; bf16 2e-2 (8 mantissa bits)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the JAX kernel sweep and the paper's two layers (B=8, Din=95 / 50, H=50)
SHAPES = [(1, 7, 5), (8, 96, 50), (16, 128, 128), (5, 33, 200), (8, 95, 50),
          (8, 50, 50)]
T_STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread is as fast, and it leaves the other
    cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq_inputs(T, B, Din, H, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(T, B, Din).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32),
            (rng.randn(B, H) * 0.5).astype(np.float32),
            (rng.randn(Din + H, 4 * H) * 0.1).astype(np.float32),
            (rng.randn(4 * H) * 0.1).astype(np.float32)]


def _jax_seq(cell, x_seq, h0, c0, w, b):
    """A ``lax.scan`` of ``cell`` over x_seq: (hs, cs, gates), the gates
    activated from the same z the cell computes (fp32)."""
    H = h0.shape[1]

    def step(hc, x):
        h, c = hc
        z = jnp.concatenate([x, h], -1).astype(jnp.float32) @ \
            w.astype(jnp.float32) + b.astype(jnp.float32)
        gates = jnp.concatenate([jax.nn.sigmoid(z[:, :2 * H]),
                                 jnp.tanh(z[:, 2 * H:3 * H]),
                                 jax.nn.sigmoid(z[:, 3 * H:])], -1)
        h, c = cell(x, h, c, w, b)
        return (h, c), (h, c, gates)

    _, (hs, cs, gates) = jax.lax.scan(step, (h0, c0), x_seq)
    return hs, cs, gates


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# (a) the plain version against the JAX scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Din,H", SHAPES)
def test_lstm_seq_plain_matches_jax_scan(B, Din, H):
    arrs = _seq_inputs(T_STEPS, B, Din, H, seed=B * 1000 + Din)
    hs, cs, gates = ref.lstm_seq(*(torch.from_numpy(a) for a in arrs))
    assert hs.shape == cs.shape == (T_STEPS, B, H)
    assert gates.shape == (T_STEPS, B, 4 * H) and gates.dtype == torch.float32
    want = _jax_seq(jref.lstm_cell, *(jnp.asarray(a) for a in arrs))
    for name, got, w in zip(("hs", "cs", "gates"), (hs, cs, gates), want):
        _close(got, w, TOL["float32"], name)


def test_lstm_seq_plain_matches_pallas_scan():
    arrs = _seq_inputs(T_STEPS, 8, 95, 50, seed=3)
    hs, cs, _ = ref.lstm_seq(*(torch.from_numpy(a) for a in arrs))
    cell = lambda x, h, c, w, b: jops.lstm_cell(x, h, c, w, b,  # noqa: E731
                                                interpret=True)
    want = _jax_seq(cell, *(jnp.asarray(a) for a in arrs))
    _close(hs, want[0], TOL["float32"], "hs")
    _close(cs, want[1], TOL["float32"], "cs")


def test_lstm_seq_plain_bf16_matches_jax_scan():
    """bf16 inputs, h and c rounded to bf16 every step in both packages."""
    arrs = _seq_inputs(T_STEPS, 8, 50, 50, seed=5)
    j_in = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    t_in = [torch.from_numpy(np.array(a.astype(jnp.float32)))
            .to(torch.bfloat16) for a in j_in]
    hs, cs, gates = ref.lstm_seq(*t_in)
    assert hs.dtype == cs.dtype == torch.bfloat16
    want = _jax_seq(jref.lstm_cell, *j_in)
    for name, got, w in zip(("hs", "cs", "gates"), (hs, cs, gates), want):
        _close(got, w, TOL["bfloat16"], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_seq_plain_is_chained_cells(dtype):
    """The contract the card holds the kernel to bit for bit: the sequence
    equals step after step of ``lstm_cell`` fed its own outputs."""
    x, h, c, w, b = (torch.from_numpy(a).to(dtype)
                     for a in _seq_inputs(T_STEPS, 3, 7, 5, seed=9))
    hs, cs, _ = ref.lstm_seq(x, h, c, w, b)
    for t in range(T_STEPS):
        h, c = ref.lstm_cell(x[t], h, c, w, b)
        assert torch.equal(hs[t], h) and torch.equal(cs[t], c)


def test_ops_dispatch_cpu_goes_to_plain_lstm_seq():
    args = [torch.from_numpy(a) for a in _seq_inputs(4, 3, 4, 5, seed=1)]
    before = K.lstm_seq.launches
    for got, want in zip(ops.lstm_seq(*args), ref.lstm_seq(*args)):
        assert torch.equal(got, want)
    assert K.lstm_seq.launches == before


# the CUDA wrapper refuses what the kernel does not take, before any build
# or launch (as tests/test_torch_lstm.py::test_cuda_wrapper_raises)
@pytest.mark.parametrize("bad,why", [("cpu", "x is on cpu, not a CUDA "
                                             "device"),
                                     ("dtype", "bias is torch.float64"),
                                     ("shape", "kernel has shape"),
                                     ("h0", "c has shape"),
                                     ("strided", "x is not contiguous"),
                                     ("rank", "x must be 3-D"),
                                     ("empty", "empty shape"),
                                     ("float64", "dtype torch.float64 not "
                                                 "supported")])
def test_lstm_seq_wrapper_raises(bad, why):
    args = [torch.from_numpy(a) for a in _seq_inputs(3, 2, 3, 4, seed=2)]
    if bad == "dtype":
        args[4] = args[4].double()
    elif bad == "shape":
        args[3] = args[3][:-1]
    elif bad == "h0":
        args[2] = args[2][:1]
    elif bad == "strided":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "rank":
        args[0] = args[0][0]
    elif bad == "empty":
        args[0] = args[0][:0]
    elif bad == "float64":
        args = [a.double() for a in args]
    before = K.lstm_seq.launches
    with pytest.raises(ValueError, match=f"lstm_seq kernel: {why}"):
        K.lstm_seq(*args)
    assert K.lstm_seq.launches == before


# ---------------------------------------------------------------------------
# (b) _Seq's backpropagation through time
# ---------------------------------------------------------------------------

def _projection(T, B, H, seed):
    return np.random.RandomState(seed).randn(T, B, H).astype(np.float32)


def _seq_grads_torch(layer, arrs, r, x_grad):
    """Gradients of sum(hs * r) by x (where asked), h0, c0, W, b."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    if not x_grad:
        ts[0].requires_grad_(False)
    hs = layer(*ts)
    loss = (hs * torch.from_numpy(r)).sum()
    wrt = ts if x_grad else ts[1:]
    return torch.autograd.grad(loss, wrt)


def _per_step_plain(x_seq, h0, c0, w, b):
    h, c = h0, c0
    hs = []
    for x in x_seq:
        h, c = ref.lstm_cell(x, h, c, w, b)
        hs.append(h)
    return torch.stack(hs)


@pytest.mark.parametrize("B,Din,H", [(1, 7, 5), (8, 95, 50), (3, 33, 20)])
@pytest.mark.parametrize("x_grad", [True, False], ids=["dx", "no_dx"])
def test_seq_backward_matches_jax_grad(B, Din, H, x_grad):
    """fp32, 2e-5: dx (where x needs it), dh0, dc0, dW, db of sum(hs * r)
    against jax.grad of the lax.scan over the JAX oracle."""
    T = 8
    arrs = _seq_inputs(T, B, Din, H, seed=Din + H)
    r = _projection(T, B, H, seed=B)

    def loss(*a):
        hs = _jax_seq(jref.lstm_cell, *a)[0]
        return jnp.sum(hs * r)

    argnums = (0, 1, 2, 3, 4) if x_grad else (1, 2, 3, 4)
    want = jax.grad(loss, argnums=argnums)(*(jnp.asarray(a) for a in arrs))
    layer = lambda x, h, c, w, b: TLSTM._Seq.apply(x, h, c, w, b)  # noqa
    got = _seq_grads_torch(layer, arrs, r, x_grad)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL["float32"], f"grad {argnums[i]}")


@pytest.mark.parametrize("B,Din,H", [(2, 9, 6), (8, 50, 50)])
def test_seq_backward_matches_per_step_autograd(B, Din, H):
    """fp32, 2e-5: the same gradients through torch autograd of the
    per-step plain path (the port's backward before the sequence kernel)."""
    T = 10
    arrs = _seq_inputs(T, B, Din, H, seed=7 * H)
    r = _projection(T, B, H, seed=11)
    got = _seq_grads_torch(
        lambda x, h, c, w, b: TLSTM._Seq.apply(x, h, c, w, b), arrs, r, True)
    want = _seq_grads_torch(_per_step_plain, arrs, r, True)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL["float32"],
                                   atol=TOL["float32"], err_msg=f"grad {i}")
