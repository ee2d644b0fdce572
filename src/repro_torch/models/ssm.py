"""Mamba-1 selective-state-space block (the falcon-mamba and jamba mixer),
as ``repro.models.ssm``.

Plain functions on tensors over the JAX package's tree (``in_proj [D,
2 Di]``, ``conv_w [K, Di]``, ``x_proj [Di, R + 2N]``, ``dt_proj [R, Di]``,
``out_proj [Di, D]`` in the model's dtype; ``dt_bias [Di]``, ``A_log [Di,
N]`` and ``Dskip [Di]`` in fp32 whatever the model's dtype), so ``bridge``
carries weights across unchanged. Every cast of the reference is kept: the
scan runs in fp32 and its output is cast back to the model's dtype before
the gate.

The recurrence h_t = a_t h_{t-1} + b_t runs as the reference's chunked
scan: a loop over chunks of ``cfg.ssm.chunk`` positions carrying the
state, the tail padded with zeros (dt = 0 gives a = 1 and b = 0, so the
state passes through unchanged), and within a chunk ``lax.associative_scan``'s
odd/even recursion in the same order of combines (``_associative_scan``).
That bounds the ``[B, chunk, Di, N]`` fp32 tensors to one chunk: at
falcon-mamba-7b's prefill (B = 4, S = 1,024, Di = 8,192, N = 16) the whole
sequence would be 2.15 GB a tensor, a chunk of 128 is 268 MB. The scan is
plain torch on the CPU and on the card alike (the reference's is jnp, not a
Pallas kernel).

Decode carries O(1) state: the conv window ``[B, K-1, Di]`` in the cache's
dtype and h ``[B, Di, N]`` in fp32. ``apply_ssm`` and ``apply_ssm_step``
return the new state, as the JAX package does; ``models/blocks.py`` copies
it into the stacked cache in place.

Split over ``model`` (``split``: d_inner on ``model``,
``distributed/spmd.py``) a rank runs its channels ``[lo, lo + n)``: it
takes their columns of x and of z from the whole ``in_proj`` (the
columns are ``[x | z]``, so a contiguous shard would hold x alone on the
first ranks), and its ``conv``/``dt``/``A``/``D`` leaves, its decode state
and its ``out_proj`` rows are its own. ``x_proj``'s rows contract over
d_inner, so its partial (dt, B, C) is summed over ``model`` (both ways:
its consumers are the rank's channels), and the output is a partial sum,
which the block's exit sums.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_ssm(generator, cfg, dtype, device):
    """The mixer's params; without a generator, unfilled (shapes only, as
    ``layers.dense_init``). A is the S4D-real init (A_log = log 1..N a
    row), dt_bias the inverse softplus of dt drawn log-uniform in [1e-3,
    1e-1] (the mamba default)."""
    D, Di, N, R, K = (cfg.d_model, cfg.d_inner(), cfg.ssm.d_state,
                      cfg.dt_rank(), cfg.ssm.d_conv)
    f32 = torch.float32
    A = torch.arange(1, N + 1, dtype=f32, device=device)[None, :].repeat(Di, 1)
    if generator is None:
        u = torch.empty((Di,), dtype=f32, device=device)
    else:
        u = torch.rand((Di,), dtype=f32, generator=generator,
                       device=generator.device).to(device)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))      # inverse softplus
    return {
        "in_proj": dense_init(generator, (D, 2 * Di), dtype, device),
        "conv_w": dense_init(generator, (K, Di), dtype, device,
                             scale=0.5 / math.sqrt(K)),
        "conv_b": torch.zeros((Di,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, (Di, R + 2 * N), dtype, device),
        "dt_proj": dense_init(generator, (R, Di), dtype, device,
                              scale=R ** -0.5),
        "dt_bias": dt_bias,
        "A_log": torch.log(A),
        "Dskip": torch.ones((Di,), dtype=f32, device=device),
        "out_proj": dense_init(generator, (Di, D), dtype, device,
                               scale=0.02 / math.sqrt(2 * max(cfg.n_layers,
                                                              1))),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv along the sequence. x [B, S, Di], w [K, Di];
    conv_state [B, K-1, Di] (a cache) or None (zeros on the left).
    Returns (y [B, S, Di], the new conv state [B, K-1, Di])."""
    K = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # [B, S+K-1, Di]
    # the reference's sum(): the taps added in order, from 0
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else torch.zeros_like(pad)
    return y, new_state


def _in_proj(p, split):
    """``in_proj`` [D, 2 Di], or under a ``split`` the rank's columns of x
    and of z [D, 2 n] from the whole matrix."""
    w = p["in_proj"]
    if split is None:
        return w
    Di = w.shape[-1] // 2
    return torch.cat([w.narrow(-1, split.lo, split.n),
                      w.narrow(-1, Di + split.lo, split.n)], dim=-1)


def _ssm_params(p, x_conv, cfg, split=None):
    """x_conv [..., Di] -> (dt [..., Di], B [..., N], C [..., N], A [Di, N]),
    all fp32: the projection is cast to fp32 and dt_proj with it."""
    N, R = cfg.ssm.d_state, cfg.dt_rank()
    proj = x_conv @ p["x_proj"]
    if split is not None:
        proj = split.layout.sum_model(proj)
    dt_in, Bm, Cm = torch.split(proj.float(), [R, N, N], dim=-1)
    dt = F.softplus(dt_in @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                # [Di, N]
    return dt, Bm, Cm, A


def _combine(lhs, rhs):
    """The scan's operator on (a, b) pairs, lhs the earlier:
    (a1 a2, a2 b1 + b2)."""
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """[B, n, ...] and [B, n or n-1, ...] -> [B, 2n or 2n-1, ...]:
    even[0], odd[0], even[1], ..."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
    return out


def _associative_scan(elems):
    """Inclusive scan of ``_combine`` along dim 1 of each of ``elems``,
    ``lax.associative_scan``'s recursion: combine adjacent pairs, scan the
    half, then the even positions from the odd results, interleaved. It does
    O(L) work (Hillis-Steele does O(L log L)) and adds in the reference's
    order."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _associative_scan(_combine([e[:, 0:-1:2] for e in elems],
                                     [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _scan_chunk(h0, a, b):
    """h_t = a_t h_{t-1} + b_t within one chunk by the associative scan.
    a, b [B, L, Di, N]; h0 [B, Di, N]. Returns (h_all [B, L, Di, N],
    h_last)."""
    a_pref, b_pref = _associative_scan([a, b])
    h_all = a_pref * h0[:, None] + b_pref
    return h_all, h_all[:, -1]


def _chunk(h, A, xch, dch, bch, cch):
    """One chunk of the selective scan (the reference's scan body): the
    discretised a = exp(dt A) and b = dt x B, the scan from the carried
    state h [B, Di, N], and the readout C . h. xch, dch [B, L, Di]; bch,
    cch [B, L, N], all fp32. Returns (h at the chunk's end, y [B, L, Di])."""
    a = torch.exp(dch[..., None] * A)                         # [B,L,Di,N]
    bbar = (dch * xch)[..., None] * bch[:, :, None, :]        # [B,L,Di,N]
    h_all, h_last = _scan_chunk(h, a, bbar)
    return h_last, torch.einsum("bldn,bln->bld", h_all, cch)


def apply_ssm(p, x, cfg, state: Optional[dict] = None, split=None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence (training, prefill) Mamba mixer. x [B, S, D].

    state: None for training; a prefill passes the (zeroed) cache to
    receive the final state (under a ``split``, the rank's channels').
    Returns (y [B, S, D], the new state or None)."""
    B, S, _ = x.shape
    Di, N = p["A_log"].shape[0], cfg.ssm.d_state
    xi, z = (x @ _in_proj(p, split)).chunk(2, dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dt, Bm, Cm, A = _ssm_params(p, xc, cfg, split)            # dt [B,S,Di]

    chunk = max(min(cfg.ssm.chunk, S), 1)
    nchunk = -(-S // chunk)
    pad = nchunk * chunk - S

    def pad_seq(t):
        return F.pad(t, (0, 0, 0, pad)) if pad else t

    xcf, dtc, Bc, Cc = (pad_seq(t) for t in (xc.float(), dt, Bm, Cm))
    h = (state["h"].float() if state is not None
         else torch.zeros((B, Di, N), dtype=torch.float32, device=x.device))
    ys = []
    for c in range(nchunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        h, y = _chunk(h, A, xcf[:, sl], dtc[:, sl], Bc[:, sl], Cc[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + xc.float() * p["Dskip"]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv.to(state["conv"].dtype),
                     "h": h.to(state["h"].dtype)}
    return out, new_state


def apply_ssm_step(p, x, cfg, state: dict, split=None
                   ) -> Tuple[torch.Tensor, dict]:
    """One decode step. x [B, 1, D]; state {conv [B, K-1, Di], h [B, Di,
    N]} (under a ``split``, the rank's channels'). Returns (y [B, 1, D],
    the new state)."""
    xi, z = (x[:, 0] @ _in_proj(p, split)).chunk(2, dim=-1)  # [B, Di]
    window = torch.cat([state["conv"].to(xi.dtype), xi[:, None]], dim=1)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)
    dt, Bm, Cm, A = _ssm_params(p, xc, cfg, split)            # dt [B, Di]
    a = torch.exp(dt[..., None] * A)                          # [B, Di, N]
    bbar = (dt * xc.float())[..., None] * Bm[:, None, :]
    h = a * state["h"].float() + bbar
    y = torch.einsum("bdn,bn->bd", h, Cm) + xc.float() * p["Dskip"]
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    new_state = {"conv": window[:, 1:].to(state["conv"].dtype),
                 "h": h.to(state["h"].dtype)}
    return out, new_state


def init_ssm_state(cfg, batch: int, dtype, device) -> dict:
    """A zeroed decode state: conv in ``dtype``, h in fp32."""
    return {"conv": torch.zeros((batch, cfg.ssm.d_conv - 1, cfg.d_inner()),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.d_inner(), cfg.ssm.d_state),
                             dtype=torch.float32, device=device)}
