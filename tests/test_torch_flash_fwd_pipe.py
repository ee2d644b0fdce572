"""The bf16 flash forward at hd 64 and 128 as ``flash_kernel_wgmma_pipe`` of
``csrc/flash_attention.cu`` runs it, on the CPU, against the JAX package.

- ``_pipe_plan``, a model of the launcher's and the kernel's plan
  (``tc::launch``, ``pipe_at_128``, ``launch_pipe`` and the kernel's own
  indexing): two warpgroups of 64 folded rows a block at hd 64, three at
  hd 128 when G > 1 (at G = 1 hd 128 keeps ``flash_kernel_wgmma<128,
  64>``: 128-row tiles, two consumer warpgroups, the same plan); q tiles
  of whole positions (one TMA box of G heads x positions a 64-column
  chunk, or one position's share where G is larger);
  each block's kv tiles of 64 from the window's first to the causal bound
  of its last row. At hd 64 and 128 and G = 1, 2, 7, 8, 12, 14 and 16 over
  the masks, every folded row is covered by exactly one warpgroup and
  every visible (row, key) pair lies in a kv tile its block visits.
- Where G divides a block's rows, every warpgroup owns the rows it owns in
  the yardstick ``flash_kernel_wgmma<HD, 64>`` (tiles of 128 rows), which
  is where ``chip_smoke.py`` gates the two bit for bit. The plan takes its
  kernel and warpgroups from ``chip_smoke.py`` (``fwd_pipe_kernel``,
  ``fwd_pipe_warpgroups``), which a table of config shapes pins, and
  holds ``fwd_pipe_bit_equal`` to the rows.
- The arithmetic at that plan (``test_torch_attention._tc_model``: kv
  tiles of 64, S over hd in one chain, P as bf16 hi + lo) through the
  wrapper's padding against the JAX oracle at chip_smoke.py's gate (rtol
  2e-2, atol 5e-4): a qwen1.5-110b width cut at hd 128 and 96 (padded to
  128), stablelm-1.6b (G = 1) and internvl2-1b (G = 7) cuts at hd 64 and
  48 (padded to 64), inputs x0.5 and x2.
- ``route`` and ``native_head_dim`` send bf16 hd 33-128 to ``wgmma`` at 64
  or 128.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as FA
from test_torch_attention import (MASKS, QWEN_ATOL, QWEN_RTOL, _both,
                                  _gate_excess, _qwen_cut_hd, _tc_plan,
                                  _tc_wrapped)

KV_TILE = 64
YARD_ROWS = 128           # flash_kernel_wgmma: 128 folded rows a block
PLAN_GROUPS = (1, 2, 7, 8, 12, 14, 16)
PLAN_MASKS = MASKS + [(False, 100)]


@functools.cache
def _chip_smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only; its phases run on the card alone)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipe_plan(S, H, Kv, hd, causal=True, window=0, B=1):
    """The plan of the bf16 forward for q [B, S, H, hd], its kernel
    ``chip_smoke.fwd_pipe_kernel`` (two consumer warpgroups in
    flash_kernel_wgmma<128, 64>, ``fwd_pipe_warpgroups`` in the pipe),
    block by block in grid order, as ``launch_pipe`` and the kernel compute
    it: {"kernel", "warpgroups", "tile_rows", "n_qtiles", "blocks"}, each
    block {"b", "kvh", "qt", "rows": (r0, row_end), "box": (first head,
    first position, heads, positions), "kv_tiles": (first, end), "wg_rows":
    [(w0, w1)] a warpgroup, empty where it has no row}."""
    G = H // Kv
    kernel = _chip_smoke().fwd_pipe_kernel(hd, G)
    nwg = 2 if kernel.startswith("flash_kernel_wgmma<") else \
        _chip_smoke().fwd_pipe_warpgroups(hd)
    rows = 64 * nwg
    if G > rows:
        gh = next(d for d in range(rows, 0, -1) if G % d == 0)
        np_ = 1
    else:
        gh, np_ = G, rows // G
    tile_rows = gh * np_
    n_rows = S * G
    n_qtiles = -(-n_rows // tile_rows)
    per_tile = Kv * B                    # gridDim.x / n_qtiles (BlockPos)
    blocks = []
    for x in range(n_qtiles * per_tile):
        qt_lin, rest = divmod(x, per_tile)
        qt = n_qtiles - 1 - qt_lin if causal else qt_lin
        kvh, b = rest % Kv, rest // Kv
        r0 = qt * tile_rows
        row_end = min(r0 + tile_rows, n_rows)
        kv_end = min(S, (row_end - 1) // G + 1) if causal else S
        kv_begin = max(0, r0 // G - window + 1) if window > 0 else 0
        t_begin = kv_begin // KV_TILE
        t_end = -(-kv_end // KV_TILE)
        wg_rows = [(min(r0 + 64 * w, row_end), min(r0 + 64 * w + 64, row_end))
                   for w in range(nwg)]
        blocks.append(dict(b=b, kvh=kvh, qt=qt, rows=(r0, row_end),
                           box=(kvh * G + r0 % G, r0 // G, gh, np_),
                           kv_tiles=(t_begin, t_end), wg_rows=wg_rows))
    return dict(kernel=kernel, warpgroups=nwg, tile_rows=tile_rows,
                n_qtiles=n_qtiles, blocks=blocks)


def _visible(i, j, causal, window):
    """Key j is visible to query position i (``ref._mask``)."""
    ok = np.ones(np.broadcast(i, j).shape, bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= j > i - window
    return ok


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal,window", PLAN_MASKS)
@pytest.mark.parametrize("G", PLAN_GROUPS)
def test_pipe_plan_covers_every_row_and_visible_pair(G, causal, window, hd):
    B, S, Kv = 2, 300, 2
    plan = _pipe_plan(S, G * Kv, Kv, hd, causal, window, B)
    n_rows = S * G
    assert len(plan["blocks"]) == plan["n_qtiles"] * Kv * B
    seen = {}
    for blk in plan["blocks"]:
        r0, row_end = blk["rows"]
        assert r0 < row_end <= r0 + plan["tile_rows"]
        # the q box holds the tile's folded rows in order: heads of one
        # position from r0 % G, then the next position's
        h0, p0, gh, npos = blk["box"]
        g0 = h0 - blk["kvh"] * G
        assert 0 <= g0 and g0 + gh <= G and gh * npos == plan["tile_rows"]
        box_rows = [(p0 + p) * G + g0 + g for p in range(npos)
                    for g in range(gh)]
        assert box_rows == list(range(r0, r0 + plan["tile_rows"]))
        # warpgroups of 64 rows each, in order, covering the tile's rows
        covered = [r for w0, w1 in blk["wg_rows"] for r in range(w0, w1)]
        assert covered == list(range(r0, row_end))
        key = (blk["b"], blk["kvh"])
        for r in covered:
            seen.setdefault(key, []).append(r)
        # every key some row of the block sees lies in its kv tiles, and
        # the first and the last tile it visits hold such a key
        pos = np.arange(r0, row_end)[:, None] // G
        keys = np.arange(S)[None, :]
        vis = _visible(pos, keys, causal, window).any(0)
        t0, t1 = blk["kv_tiles"]
        assert np.all(~vis[:t0 * KV_TILE]) and np.all(~vis[t1 * KV_TILE:])
        assert vis[t0 * KV_TILE:(t0 + 1) * KV_TILE].any()
        assert vis[(t1 - 1) * KV_TILE:t1 * KV_TILE].any()
    assert sorted(seen) == [(b, h) for b in range(B) for h in range(Kv)]
    for rows in seen.values():
        assert sorted(rows) == list(range(n_rows))
    if causal:       # heaviest q tile first
        assert plan["blocks"][0]["qt"] == plan["n_qtiles"] - 1


@pytest.mark.parametrize("hd,G,nwg,tile_rows", [
    (64, 1, 2, 128),      # stablelm-1.6b, whisper-base
    (64, 7, 2, 126),      # internvl2-1b: 18 whole positions
    (128, 1, 2, 128),     # deepseek-moe-16b: flash_kernel_wgmma<128, 64>
    (128, 4, 3, 192),     # jamba-v0.1-52b
    (128, 8, 3, 192),     # qwen1.5-110b: 24 positions
    (128, 7, 3, 189),
    (128, 14, 3, 182),
    (192, 12, 2, 120),    # nemotron-4-340b
    (64, 200, 2, 100)])   # G above the block's rows: a position's share
def test_pipe_plan_warpgroups_and_tile_rows(hd, G, nwg, tile_rows):
    plan = _pipe_plan(64, G, 1, hd)
    assert (plan["warpgroups"], plan["tile_rows"]) == (nwg, tile_rows)
    assert plan["kernel"] == ("flash_kernel_wgmma<128, 64>" if (hd, G) ==
                              (128, 1) else
                              f"flash_kernel_wgmma_pipe<{hd}, {nwg}>")
    assert _tc_plan(hd) == (KV_TILE, None, hd)


def _yard_wg_starts(S, G):
    """The folded rows each warpgroup of flash_kernel_wgmma<HD, 64> starts
    at: 128-row tiles, two warpgroups of 64."""
    return set(range(0, -(-S * G // YARD_ROWS) * YARD_ROWS, 64))


@pytest.mark.parametrize("hd", [64, 128, 192])
def test_pipe_rows_are_the_yardsticks_where_g_divides_them(hd):
    """A warpgroup of flash_kernel_wgmma_pipe starts at the same folded row
    as one of the yardstick's, so its kv tiles take the same scaling and
    its rows the same bits, exactly where G divides the block's rows:
    chip_smoke.py's ``fwd_pipe_bit_equal``, which gates bit-equality on
    the card there."""
    S = 256
    for G in range(1, 17):
        plan = _pipe_plan(S, G, 1, hd)
        starts = {w0 for blk in plan["blocks"]
                  for w0, w1 in blk["wg_rows"] if w1 > w0}
        same = starts <= _yard_wg_starts(S, G)
        assert same == (64 * plan["warpgroups"] % G == 0)
        assert same == _chip_smoke().fwd_pipe_bit_equal(hd, G)


def test_route_sends_bf16_hd_33_to_128_to_the_pipe_widths():
    bf = torch.bfloat16
    for hd in range(33, 129):
        assert FA.route(bf, hd, 1024, 8) == "wgmma"
        assert FA.native_head_dim(hd, bf) == (64 if hd <= 64 else 128)
        assert FA.native_head_dim(hd, bf) in _chip_smoke().FWD_PIPE_DIMS
    assert [FA.native_head_dim(hd, bf) for hd in (1, 16, 17, 32)] == \
        [16, 16, 32, 32]
    assert FA.native_head_dim(129, bf) == 192


@functools.cache
def _cut(S, H, Kv, hd, scale, seed):
    """q, k, v [1, S, heads, hd] N(0, 1) x scale in bf16 (torch) and the
    JAX oracle's causal output, made once for the tests that share them."""
    rng = np.random.RandomState(seed)
    (jq, tq), (jk, tk), (jv, tv) = [
        _both((rng.randn(1, S, n, hd) * scale).astype(np.float32),
              "bfloat16") for n in (H, Kv, Kv)]
    return tq, tk, tv, np.asarray(jref.flash_attention(jq, jk, jv),
                                  np.float32)


@pytest.mark.parametrize("hd", [128, 96])
@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_pipe_model_meets_the_qwen_gate(hd, scale):
    """qwen1.5-110b's prefill attention cut in width (S 1,024, G = 8, one
    kv head) at hd 128 and at 96 through the wrapper's padding to 128."""
    tq, tk, tv, want = _qwen_cut_hd(hd, scale)
    got = _tc_wrapped(tq, tk, tv)
    assert got.shape == tq.shape and got.dtype == torch.bfloat16
    assert _gate_excess(got, want, QWEN_RTOL) <= QWEN_ATOL


@pytest.mark.parametrize("hd", [64, 48])
@pytest.mark.parametrize("scale", [0.5, 2.0])
@pytest.mark.parametrize("arch,H,Kv", [("stablelm-1.6b", 4, 4),
                                       ("internvl2-1b", 14, 2)])
def test_pipe_model_meets_the_gate_at_hd64_cuts(arch, H, Kv, scale, hd):
    """stablelm-1.6b's (G = 1) and internvl2-1b's (G = 7) training attention
    cut in length and heads (S 512) at hd 64 and at 48 through the
    padding to 64, at chip_smoke.py's gate."""
    tq, tk, tv, want = _cut(512, H, Kv, hd, scale, H + hd)
    assert _gate_excess(_tc_wrapped(tq, tk, tv), want, QWEN_RTOL) <= \
        QWEN_ATOL


@pytest.mark.parametrize("arch,H,Kv", [("stablelm-1.6b", 4, 4),
                                       ("internvl2-1b", 14, 2)])
def test_pipe_model_single_bf16_p_misses_the_gate_at_hd64(arch, H, Kv):
    """At hd 64 too the second product is needed: P rounded once to bf16
    misses the same gate at the peaked (x2) cut."""
    tq, tk, tv, want = _cut(512, H, Kv, 64, 2.0, H + 64)
    assert _gate_excess(_tc_wrapped(tq, tk, tv, split_p=False), want,
                        QWEN_RTOL) > QWEN_ATOL
