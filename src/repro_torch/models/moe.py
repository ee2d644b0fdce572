"""Mixture-of-Experts, as ``repro.models.moe``: top-k routing, the
capacity-bounded sort dispatch and the all-experts dense oracle over one
parameter layout.

- ``"sort"`` (the default): each (token, expert) assignment is argsorted
  by expert id (a stable sort), placed at its position within its expert
  into a ``[E, C, D]`` buffer of capacity ``C = max(int(k * T * cf / E),
  1)``, the experts run as batched products (``torch.bmm``), and the
  outputs are gathered back and added into their tokens, weighted by the
  gates. Assignments past an expert's capacity are dropped (GShard /
  Switch semantics): at decode, four tokens of deepseek-moe-16b give C = 1,
  so any expert chosen twice drops one of them, as in the JAX package.
- ``"dense"`` (the oracle): every expert on every token, combined by the
  gates; exact, nothing dropped.

Shared, always-on experts (DeepSeek-MoE) are added by ``apply_moe``; the
dense residual branch (Arctic) is the block's. The router is fp32 whatever
the config's dtype, and the tree is the JAX package's (``router [D, E]``,
``experts.{wi, wg} [E, D, F]``, ``experts.wo [E, F, D]``,
``shared.{wi, wg} [D, S*F]``, ``shared.wo [S*F, D]``), so ``bridge`` carries
weights across unchanged. The JAX package's expert-parallel sharding
constraints (``expert_axis``, ``token_axes``) wait for ROADMAP Queue 1
item 9.

Every expert choice goes through ``route``, one module-level function, so
a comparison can record one run's choices and replay them in another
(``chip_smoke.py``). The scatters are ``index_put`` with ``accumulate`` and
``index_add``: deterministic on the card under
``torch.use_deterministic_algorithms``; no atomics of the port's own.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(generator, cfg, dtype, device):
    """The moe sublayer's params, drawn in the JAX package's order."""
    D = cfg.d_model
    m = cfg.moe
    F_ = m.d_expert or cfg.d_ff
    E = m.num_experts
    out_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    gated = cfg.mlp == "swiglu"
    p = {"router": dense_init(generator, (D, E), torch.float32, device)}
    experts = {"wi": dense_init(generator, (E, D, F_), dtype, device),
               "wo": dense_init(generator, (E, F_, D), dtype, device,
                                scale=out_scale)}
    if gated:
        experts["wg"] = dense_init(generator, (E, D, F_), dtype, device)
    p["experts"] = experts
    if m.num_shared:
        S = m.num_shared * F_
        shared = {"wi": dense_init(generator, (D, S), dtype, device),
                  "wo": dense_init(generator, (S, D), dtype, device,
                                   scale=out_scale)}
        if gated:
            shared["wg"] = dense_init(generator, (D, S), dtype, device)
        p["shared"] = shared
    return p


def _act(up, gate_in, kind: str):
    """The expert MLP's activation of ``up`` (and of ``gate_in`` for
    SwiGLU)."""
    if kind == "swiglu":
        return F.silu(gate_in) * up
    if kind == "squared_relu":
        return torch.square(F.relu(up))
    return F.gelu(up, approximate="tanh")


def _expert_ffn(ep, h, kind: str):
    """h [E, C, D] -> [E, C, D] with per-expert weights."""
    up = torch.bmm(h, ep["wi"])
    gate_in = torch.bmm(h, ep["wg"]) if kind == "swiglu" else None
    return torch.bmm(_act(up, gate_in, kind), ep["wo"])


def _shared_ffn(sp, x, kind: str):
    up = x @ sp["wi"]
    gate_in = x @ sp["wg"] if kind == "swiglu" else None
    return _act(up, gate_in, kind) @ sp["wo"]


def router_probs(p, x):
    """x [T, D] -> router softmax probs [T, E] (fp32)."""
    logits = x.float() @ p["router"]
    return torch.softmax(logits, dim=-1)


def route(probs, k: int):
    """The top-k experts of each token: (gate [T, k] fp32, the chosen
    probabilities, unnormalised; idx [T, k] int64), largest first, a tie
    going to the lower expert index (``jax.lax.top_k``'s order: a stable
    descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def load_balance_loss(probs, idx, E: int):
    """Switch-style aux loss: E * sum_e f_e * P_e / k (fp32 scalar)."""
    onehot = F.one_hot(idx, E).float()                       # [T, k, E]
    f = torch.mean(torch.sum(onehot, dim=1), dim=0)          # [E]
    P = torch.mean(probs, dim=0)                             # [E]
    return E * torch.sum(f * P) / max(idx.shape[-1], 1)


def _gates(probs, k: int):
    gate, idx = route(probs, k)
    return gate / torch.sum(gate, dim=-1, keepdim=True), idx


def apply_moe_dense(p, x, cfg, with_aux: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The oracle: every expert on every token. x [T, D] -> ([T, D],
    aux; None unless ``with_aux``)."""
    m = cfg.moe
    probs = router_probs(p, x)
    gate, idx = _gates(probs, m.top_k)
    gate = gate.to(x.dtype)
    ep = p["experts"]
    hT = torch.einsum("td,edf->etf", x, ep["wi"])
    if "wg" in ep:
        hT = F.silu(torch.einsum("td,edf->etf", x, ep["wg"])) * hT
    elif cfg.mlp == "squared_relu":
        hT = torch.square(F.relu(hT))
    else:
        hT = F.gelu(hT, approximate="tanh")
    yT = torch.einsum("etf,efd->etd", hT, ep["wo"])          # [E, T, D]
    combine = torch.zeros((x.shape[0], m.num_experts), dtype=x.dtype,
                          device=x.device).scatter_add(1, idx, gate)
    out = torch.einsum("te,etd->td", combine, yT)
    return out, (load_balance_loss(probs, idx, m.num_experts) if with_aux
                 else None)


def capacity(cfg, T: int, capacity_factor: float) -> int:
    """Slots an expert holds for T tokens: the JAX package's float
    expression."""
    m = cfg.moe
    return max(int(m.top_k * T * capacity_factor / m.num_experts), 1)


def dispatch(idx, C: int):
    """Where each (token, expert) assignment of idx [T, k] goes:
    (order, the stable argsort of the flattened assignments by expert;
    sorted_e, their experts in that order; token_of, their tokens; keep,
    whether each holds one of its expert's C slots, the first C
    assignments of an expert in token order; pos_cl, its slot, clamped to
    C - 1 where it is dropped), each [T*k]."""
    k = idx.shape[-1]
    flat_e = idx.reshape(-1)                                  # [T*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of = order // k
    # position within the expert group: the sorted layout's first occurrence
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(flat_e.shape[0], device=idx.device) - first
    keep = pos_in_e < C
    return order, sorted_e, token_of, keep, torch.clamp(pos_in_e, max=C - 1)


def apply_moe_sort(p, x, cfg, capacity_factor: float, with_aux: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort-based capacity dispatch. x [T, D] -> ([T, D], aux; None unless
    ``with_aux``)."""
    m = cfg.moe
    T, D = x.shape
    E, k = m.num_experts, m.top_k
    C = capacity(cfg, T, capacity_factor)

    probs = router_probs(p, x)
    gate, idx = _gates(probs, k)                              # [T, k]
    order, sorted_e, token_of, keep, pos_cl = dispatch(idx, C)

    # dropped rows are zero, so adding them onto a kept slot changes nothing
    keep_x = keep[:, None].to(x.dtype)
    gathered = x[token_of] * keep_x
    buf = torch.zeros((E, C, D), dtype=x.dtype, device=x.device).index_put(
        (sorted_e, pos_cl), gathered, accumulate=True)

    y_e = _expert_ffn(p["experts"], buf, cfg.mlp)             # [E, C, D]

    y_sorted = y_e[sorted_e, pos_cl] * keep_x
    g_sorted = gate.reshape(-1)[order].to(x.dtype)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(
        0, token_of, y_sorted * g_sorted[:, None])
    return out, load_balance_loss(probs, idx, E) if with_aux else None


def apply_moe(p, x, cfg, rt, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x [B, S, D] -> ([B, S, D], aux scalar; None unless ``with_aux``: a
    cached prefill or decode takes no loss), the shared experts added; a
    dense residual branch is the block's."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    if rt.moe_impl == "dense" or cfg.moe.num_experts <= 1:
        out, aux = apply_moe_dense(p, xt, cfg, with_aux)
    else:
        out, aux = apply_moe_sort(p, xt, cfg, cfg.moe.capacity_factor,
                                  with_aux)
    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + _shared_ffn(p["shared"], x, cfg.mlp)
    return out, aux
