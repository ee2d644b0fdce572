"""The bf16 flash backward at hd 64 and 128 as the two-warpgroup kernels of
``csrc/flash_attention_bwd.cu`` run it, on the CPU, against the JAX
package.

- ``_bwd_plan``, a model of the kernels' plan as the launchers and the
  kernels compute it on the card (dq: the (q tile, query head) units of a
  kv head two a block, in q-tile-major order, each warpgroup on its unit's
  kv tiles of the pair's stream; dk/dv: iteration i of a kv tile's G x n_q
  to warpgroup i % 2), covers every
  visible (query head, q tile, kv tile) pair exactly once in each launch at
  G = 1, 2, 7, 8 and 12 over the masks, with the grid sizes the launchers
  use.
- A CPU model of the new order of sums (``_pipe_bwd_model``: the rounding
  of ``test_torch_bwd_kernels._tc_bwd_model``, P and dS rounded once to
  bf16; dq summed over its unit's kv tiles in order; dk and dv summed by
  each warpgroup over its own iterations in order, warpgroup 1's partial
  added to warpgroup 0's) against JAX's ``_fa_bwd`` in fp32 at
  chip_smoke.py's gate, 2e-2 of max |grad|: the flash sweep x masks at hd
  64 and 128, an internvl2-1b width cut (S 512, 14 over 2 heads, G = 7, hd
  64) and a qwen1.5-110b cut (S 1,024, G = 8, hd 128), inputs x0.5 and x2.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from test_torch_bwd_kernels import (GRAD_GATE, LOG2E, MASKS, SWEEP, TILE,
                                    _bf, _bf16, _jax_fa_bwd, _visible)

PLAN_GROUPS = (1, 2, 7, 8, 12)
PLAN_MASKS = MASKS + [(False, 100)]


def _kv_tiles(qt, S, causal, window):
    """The kv tiles [x, y) that q tile qt's rows see (``kv_tiles`` in
    flash_attention_bwd.cu)."""
    q0, q_last = qt * TILE, min(qt * TILE + TILE, S) - 1
    lo = max(0, q0 - window + 1) if window > 0 else 0
    hi = min(S, q_last + 1) if causal else S
    return lo // TILE, -(-hi // TILE)


def _q_tiles(kt, S, causal, window):
    """The q tiles [x, y) whose rows see kv tile kt (``KvBlock``)."""
    k0, k_last = kt * TILE, min(kt * TILE + TILE, S) - 1
    lo = k0 if causal else 0
    hi = min(S, k_last + window) if window > 0 else S
    return lo // TILE, -(-hi // TILE)


H100_SMS = 132      # an H100 SXM's SMs (the launcher reads the card's count)


def _dq_pairs(hd, G):
    """Whether ``flash_bwd_dq_bf16`` takes dq on the paired kernel."""
    return hd == 128


def _bwd_plan(S, H, Kv, hd, causal=True, window=0, B=1, sms=H100_SMS):
    """The plan of the bf16 backward at hd 64 and 128 (route ``wgmma``) for
    one (batch, kv head), in launch order, as the kernels of
    flash_attention_bwd.cu compute it on the card; the grid sizes are these
    counts times B * Kv.

    ``"dq"``: one entry a block, (the kv tiles [lo, hi) it streams, its
    units), a unit (query head of the group g, q tile, its kv tiles [x, y))
    or None. ``flash_bwd_dq_wgmma_pipe`` (``_dq_pairs``): the (q tile, g)
    units in q-tile-major order, two a block (one a warpgroup), heaviest
    first when causal. Otherwise ``flash_bwd_dq_wgmma``: one unit a block,
    query head by query head, heaviest q tile first when causal.

    ``"dkdv"``: one entry a kv tile kt (from 0), the (g, q tile) iterations
    of each warpgroup that sums into its dk and dv, in order. With G > 1
    ``flash_bwd_dkdv_wgmma_pipe``: when the B * Kv * n_tiles kv tiles are
    fewer than the card's ``sms``, a cluster of two blocks takes a kv tile
    (``"dkdv_cluster"`` 2) and iteration i of its G x n_q goes to warpgroup
    i % 2 of block (i // 2) % 2, four lists, summed (0 + 1) + (2 + 3);
    otherwise one block, i to warpgroup i % 2, two lists, summed 0 + 1.
    With G = 1 ``flash_bwd_dkdv_wgmma``: one warpgroup (the second list
    empty)."""
    G = H // Kv
    n_tiles = -(-S // TILE)
    pairs = _dq_pairs(hd, G)
    if pairs:
        units = [(u % G, u // G) for u in range(n_tiles * G)]
        blocks = [units[i:i + 2] for i in range(0, len(units), 2)]
        blocks = blocks[::-1] if causal else blocks
    else:
        tiles = range(n_tiles)[::-1] if causal else range(n_tiles)
        blocks = [[(g, qt)] for qt in tiles for g in range(G)]
    step = 2 if pairs else 1
    dq = []
    for block in blocks:
        ends = [_kv_tiles(qt, S, causal, window) for _, qt in block]
        dq.append(((ends[0][0], ends[-1][1]), tuple(
            (g, qt, span) for (g, qt), span in zip(block, ends)) +
            (None,) * (step - len(block))))
    cluster = 2 if G > 1 and B * Kv * n_tiles < sms else 1
    n_wg = 2 * cluster if G > 1 else 1
    dkdv = []
    for kt in range(n_tiles):
        x, y = _q_tiles(kt, S, causal, window)
        its = [(g, qt) for g in range(G) for qt in range(x, y)]
        dkdv.append((kt, tuple(its[w::n_wg] for w in range(n_wg)) +
                     (((),) if n_wg == 1 else ())))
    return {"dq": dq, "dkdv": dkdv, "dkdv_cluster": cluster,
            "dq_kernel": "flash_bwd_dq_wgmma_pipe" if pairs
            else "flash_bwd_dq_wgmma",
            "dkdv_kernel": "flash_bwd_dkdv_wgmma_pipe" if G > 1
            else "flash_bwd_dkdv_wgmma"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seen_pairs(S, G, causal, window):
    """{(g, q tile, kv tile)} with at least one visible position pair."""
    pos = torch.arange(-(-S // TILE) * TILE)
    ok = _visible(pos, pos, S, causal, window)
    n_t = len(pos) // TILE
    tiles = ok.reshape(n_t, TILE, n_t, TILE).any(3).any(1)
    return {(g, qt, kt) for g in range(G)
            for qt, kt in torch.nonzero(tiles).tolist()}


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window", PLAN_MASKS)
@pytest.mark.parametrize("G", PLAN_GROUPS)
def test_pipe_plan_covers_every_visible_pair_once(G, causal, window, hd):
    S, Kv = 300, 2
    plan = _bwd_plan(S, G * Kv, Kv, hd, causal, window)
    n_t = -(-S // TILE)
    want = _seen_pairs(S, G, causal, window)
    per_block = 2 if _dq_pairs(hd, G) else 1
    assert len(plan["dq"]) == -(-n_t * G // per_block)
    assert all(len(units) == per_block for _, units in plan["dq"])
    assert plan["dq_kernel"] == ("flash_bwd_dq_wgmma_pipe" if _dq_pairs(hd, G)
                                 else "flash_bwd_dq_wgmma")
    assert plan["dkdv_kernel"] == ("flash_bwd_dkdv_wgmma_pipe" if G > 1
                                   else "flash_bwd_dkdv_wgmma")
    assert len(plan["dkdv"]) == n_t
    dq = []
    for (lo, hi), units in plan["dq"]:
        assert units[0] is not None
        for unit in units:
            if unit is None:
                continue
            g, qt, (x, y) = unit
            assert lo <= x <= y <= hi
            dq += [(g, qt, kt) for kt in range(x, y)]
        assert lo == units[0][2][0]
        assert hi == max(u[2][1] for u in units if u is not None)
    assert sorted(dq) == sorted(set(dq))
    assert set(dq) == want
    dkdv = [(g, qt, kt) for kt, per_wg in plan["dkdv"]
            for its in per_wg for g, qt in its]
    assert sorted(dkdv) == sorted(set(dkdv))
    assert set(dkdv) == want
    # G > 1: a kv tile's iterations dealt round the warpgroups of its
    # cluster (two blocks while the 2 x 5 kv tiles are fewer than the
    # SMs); G = 1: one warpgroup takes them all
    assert plan["dkdv_cluster"] == (2 if G > 1 else 1)
    for _, per_wg in plan["dkdv"]:
        lens = [len(its) for its in per_wg]
        if G > 1:
            assert len(lens) == 4 and max(lens) - min(lens) <= 1
            assert lens == sorted(lens, reverse=True)
        else:
            assert len(lens) == 2 and lens[1] == 0
    # heaviest first when causal: the first dq block holds the last q tile
    if causal:
        assert plan["dq"][0][1][0][1] == n_t - 1


@pytest.mark.parametrize("sms,want", [(132, 2), (10, 1), (11, 2), (1, 1)])
def test_pipe_plan_clusters_only_while_the_kv_tiles_are_fewer_than_sms(
        sms, want):
    """internvl2-1b's microbatch has 2 x 64 = 128 kv tiles, fewer than an
    H100's 132 SMs: two blocks a kv tile; at S 300 (5 tiles, 2 kv heads)
    10 kv tiles against 10 SMs: one."""
    plan = _bwd_plan(300, 14, 2, 64, sms=sms)
    assert plan["dkdv_cluster"] == want
    assert all(len(per_wg) == 2 * want for _, per_wg in plan["dkdv"])
    assert _bwd_plan(4096, 14, 2, 64)["dkdv_cluster"] == 2
    assert _bwd_plan(1024, 64, 8, 128, B=4)["dkdv_cluster"] == 1


def _pipe_bwd_model(q, k, v, out, lse, dout, causal, window, fp32=False,
                    plan=None, sms=H100_SMS):
    """What flash_bwd_dq_wgmma_pipe and flash_bwd_dkdv_wgmma_pipe compute, in
    their rounding and order of sums (``_bwd_plan``): q, k, v, out,
    dout bf16; D = rowsum(dout * out) in fp32; per 64 x 64 tile pair S and
    dP in fp32, P = 2^(S scale log2(e) - lse log2(e)) (0 where masked), dS =
    P (dP - D) scale, each rounded once to bf16 before its products; dq of
    a (q tile, query head) summed over its kv tiles in order; dk and dv of
    a kv tile as partials, each warpgroup's over its own iterations in
    order, added by block, each block's warpgroup 0 + warpgroup 1, then
    block 0's + block 1's (a cluster of two on ``sms`` SMs while the kv
    tiles are fewer); stored in bf16 (``fp32``: returned before that
    rounding). ``plan`` replaces the kernels'."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    c2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf, of, dof = (t.float().transpose(1, 2)
                           for t in (q, k, v, out, dout))   # [B, heads, S, hd]
    D = (dof * of).sum(-1)
    lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    pos = torch.arange(S)
    if plan is None:
        plan = _bwd_plan(S, H, Kv, hd, causal, window, B=B, sms=sms)

    def heads(g):           # query head g of every kv head
        return torch.arange(Kv) * G + g

    def tile(qt, kt, g):    # P and dS of one tile pair, [B, Kv, 64, 64]
        qs, ks = (slice(t * TILE, (t + 1) * TILE) for t in (qt, kt))
        hs = heads(g)
        s = qf[:, hs, qs] @ kf[:, :, ks].transpose(-1, -2)
        dp = dof[:, hs, qs] @ vf[:, :, ks].transpose(-1, -2)
        ok = _visible(pos[qs], pos[ks], S, causal, window)
        p = torch.where(ok, torch.exp2(s * c2 - lse2[:, hs, qs, None]),
                        torch.zeros(()))
        ds = p * (dp - D[:, hs, qs, None]) * scale
        return _bf(p), _bf(ds), qs, ks, hs

    dq = torch.zeros(B, H, S, hd)
    for _, units in plan["dq"]:
        for unit in units:
            if unit is None:
                continue
            g, qt, (x, y) = unit
            for kt in range(x, y):
                _, ds, qs, ks, hs = tile(qt, kt, g)
                dq[:, hs, qs] = dq[:, hs, qs] + ds @ kf[:, :, ks]
    dk = torch.zeros(B, Kv, S, hd)
    dv = torch.zeros(B, Kv, S, hd)
    for kt, per_wg in plan["dkdv"]:
        ks = slice(kt * TILE, (kt + 1) * TILE)
        rows = min(S, (kt + 1) * TILE) - kt * TILE
        parts = []
        for its in per_wg:
            pk = torch.zeros(B, Kv, rows, hd)
            pv = torch.zeros(B, Kv, rows, hd)
            for g, qt in its:
                p, ds, qs, _, hs = tile(qt, kt, g)
                pv = pv + p.transpose(-1, -2) @ dof[:, hs, qs]
                pk = pk + ds.transpose(-1, -2) @ qf[:, hs, qs]
            parts.append((pk, pv))
        blocks = [(a[0] + b[0], a[1] + b[1])
                  for a, b in zip(parts[0::2], parts[1::2])]
        while len(blocks) > 1:
            blocks = [(blocks[0][0] + blocks[1][0],
                       blocks[0][1] + blocks[1][1])] + blocks[2:]
        dk[:, :, ks], dv[:, :, ks] = blocks[0]
    res = tuple(x.transpose(1, 2) for x in (dq, dk, dv))
    return res if fp32 else tuple(x.bfloat16() for x in res)


def _pipe_vs_jax(arrs, causal, window, sms=H100_SMS):
    """The model's max|model - JAX| / max|JAX| for dq, dk, dv."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_bf16(a) for a in arrs)
    jout, jlse, want = _jax_fa_bwd(jq, jk, jv, jdo, causal, window)
    B, S, H, _ = tq.shape
    tout = torch.from_numpy(np.array(jout)).bfloat16()
    tlse = torch.from_numpy(np.array(jlse)).reshape(B, H, S)
    got = _pipe_bwd_model(tq, tk, tv, tout, tlse, tdo, causal, window,
                          sms=sms)
    return [float(np.max(np.abs(g.float().numpy() - np.asarray(w))) /
                  np.max(np.abs(np.asarray(w)))) for g, w in zip(got, want)]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,S,H,Kv", SWEEP, ids=lambda s: str(s))
def test_pipe_model_meets_the_gate_against_jax(B, S, H, Kv, causal, window,
                                               hd):
    rng = np.random.RandomState(S + H + hd)
    arrs = [rng.randn(B, S, n, hd).astype(np.float32)
            for n in (H, Kv, Kv, H)]
    errs = _pipe_vs_jax(arrs, causal, window)
    assert max(errs) <= GRAD_GATE, errs


@pytest.mark.parametrize("sms", [H100_SMS, 1])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_pipe_model_meets_the_gate_at_an_internvl2_cut(scale, sms):
    """internvl2-1b's training attention cut in length: S 512, 14 query
    heads over 2 kv heads (G = 7: the kv tiles' iterations split unevenly),
    hd 64, causal; dk/dv summed over a cluster of two blocks (the H100's
    132 SMs) and over one (a card of fewer SMs than kv tiles)."""
    rng = np.random.RandomState(7)
    arrs = [(rng.randn(1, 512, n, 64) * scale).astype(np.float32)
            for n in (14, 2, 2, 14)]
    errs = _pipe_vs_jax(arrs, True, 0, sms=sms)
    assert max(errs) <= GRAD_GATE, errs


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_pipe_model_meets_the_gate_at_a_qwen_cut(scale):
    """qwen1.5-110b's training attention cut in width: S 1,024, G = 8 (one
    kv head), hd 128, causal."""
    rng = np.random.RandomState(8)
    arrs = [(rng.randn(1, 1024, n, 128) * scale).astype(np.float32)
            for n in (8, 1, 1, 8)]
    errs = _pipe_vs_jax(arrs, True, 0)
    assert max(errs) <= GRAD_GATE, errs


def test_pipe_model_sums_dk_dv_in_another_order():
    """The two warpgroups' partials are another order of sums than one
    chain over the block's iterations: at the internvl2-1b cut the fp32 dk
    and dv differ from that chain's in some element, by float rounding
    alone (within 1e-5 of max |grad|)."""
    rng = np.random.RandomState(7)
    arrs = [rng.randn(1, 256, n, 64).astype(np.float32)
            for n in (14, 2, 2, 14)]
    (_, tq), (_, tk), (_, tv), (_, tdo) = (_bf16(a) for a in arrs)
    from repro_torch.kernels import ref
    tout, tlse = ref.flash_attention(tq.float(), tk.float(), tv.float(),
                                     causal=True, with_lse=True)
    got = _pipe_bwd_model(tq, tk, tv, tout.bfloat16(), tlse, tdo, True, 0,
                          fp32=True)
    one = _one_chain_dkdv(tq, tk, tv, tout.bfloat16(), tlse, tdo)
    for a, b in zip(got[1:], one):
        assert not torch.equal(a, b)
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def _one_chain_dkdv(q, k, v, out, lse, dout):
    """dk and dv (fp32) of the same tiles summed as one chain over each kv
    tile's iterations in order (the one-warpgroup kernel's order), causal."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    plan = _bwd_plan(S, H, Kv, hd, True, 0)
    merged = {"dq": plan["dq"],
              "dkdv": [(kt, (sorted(sum(per_wg, [])), [])) for kt, per_wg
                       in plan["dkdv"]]}
    return _pipe_bwd_model(q, k, v, out, lse, dout, True, 0, fp32=True,
                           plan=merged)[1:]
