#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero:

1. the card's name and power limit, then the build of every kernel of the
   port's paths from the sources in this checkout (``lstm_cell``,
   ``ternary``, ``rmsnorm``, ``flash_attention``), one ``nvcc`` per source,
   all started together (timed), with each kernel's registers, shared
   memory and spills;
2. each kernel against its plain PyTorch version on the card, and its time
   at the main path's shapes beside the plain version, the one-call PyTorch
   equivalent (where one exists) and the card's bound: ``lstm_cell`` over
   the JAX package's test sweep and the paper's shapes (fp32 and bf16);
   ``ternary_encode`` byte for byte and ``ternary_decode`` bit for bit over
   the JAX sweep and the six paper leaves (padded, with values planted at
   ``±s/2`` and their neighbours); ``rmsnorm`` over the JAX sweep (fp32,
   bf16, rows aligned or not) and qwen1.5-110b's prefill and decode rows
   ``[4096, 8192]`` / ``[4, 8192]`` bf16 (against ``F.rms_norm``);
   ``flash_attention`` over the JAX sweep x {causal, window 37, full} x
   {fp32, bf16} and qwen1.5-110b's prefill, q ``[4,1024,64,128]``, k/v
   ``[4,1024,8,128]``, causal, in bf16 and fp32 with a near-uniform and a
   peaked softmax (the peaked fp32 case against an fp64 attention), timed
   in bf16 against SDPA;
3. the gradient of ``lstm_loss`` at the paper width through the kernel
   against the plain-PyTorch path on the card, and the ternary codec's
   error-feedback round trip (three steps) on the card against the CPU, bit
   for bit;
4. the LSTM training paths, each through
   ``repro_torch.launch.train.run_paper`` (3 volunteers, 3 versions, the
   Coordinator) on the card with every launch count set to 0 just before
   and read just after: dense in process (model bit-equal to
   ``sequential_accumulated`` on the card, per-version losses against the
   CPU), dense over the wire (bit-equal to the same reference), TernGrad
   over the wire (the codec's byte count ``bytes_sent`` = maps x the
   ternary size of one gradient + reduces x the model; the bytes the wire
   moved, ``wire_bytes``, printed beside the dense wire run's), its
   in-process twin (bit-equal), and a short top-k run under deterministic
   mode, each run's launch counts held to its path (80 ``lstm_cell`` and,
   under TernGrad, 6 of each ternary kernel per map, else none); then the
   four dense/ternary x inproc/wire runs once more in reverse order, for
   their seconds per version;
5. where one map's time goes: wall time, and a ``torch.profiler`` window's
   device busy share and kernels;
6. the serving path: qwen1.5-110b at full width cut to 4 of its 80 layers
   (7,927,349,248 parameters, bf16, random weights from seed 0) served by
   ``repro_torch.launch.serve.serve`` (8 requests in batches of 4, 1,024
   prompt tokens, 16 generated) with every count set to 0 just before and
   read just after: exactly 8 ``flash_attention`` and 288 ``rmsnorm``
   launches and no other; prefill ms, decode ms per token, tokens/s and
   peak memory; then the same weights through the plain versions on the
   card, teacher-forced on the served tokens, every step's logits within
   the stated share of the logits' scale (beside the noise floor: the plain
   path against itself with ``F.rms_norm``); a ``torch.profiler`` window
   over one prefill and one decode step; then the same 4-layer model in
   fp32 (prompt 512), kernels against plain versions within 1e-4 of the
   logits' scale;
7. qwen1.5-110b's smoke config in fp32, the kernel path on the card
   against the plain path on the CPU: equal greedy tokens and logits within
   the stated tolerance.

The line before the last is a JSON object of per-kernel numbers; the last is
``{"ok": true, "device": {...}}``. With no CUDA card, or outside a checkout
of the repository, it fails before printing either.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores — the kernel does its fp32 math on CUDA cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12

# the paper's gradient: 6 leaves; the codec counts ceil(n/4) + 4 bytes a
# leaf under TernGrad, 13,586 bytes in all against 216,980 dense
PAPER_N_LEAVES = 6
TERNARY_GRAD_BYTES = 13_586

# tolerances of the JAX package's kernel tests (tests/test_kernels.py::_tol)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-5
# GPU vs CPU per-version losses: the two devices sum in different orders, and
# RMSprop at lr 0.1 turns a last-bit difference in a small gradient into a
# visible step (|step| ~ lr * sign(g) once |g| >> eps), so later versions
# drift apart more than float rounding alone would make them
CPU_LOSS_TOL = 1e-3

SWEEP = [(1, 7, 5), (8, 96, 50), (16, 128, 128), (5, 33, 200)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def median_ms(fn, torch, reps: int = 50, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each, in ms
    per call, after a warm-up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cell_inputs(torch, B, Din, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, Din, generator=g)
    h = torch.randn(B, H, generator=g)
    c = torch.randn(B, H, generator=g)
    w = torch.randn(Din + H, 4 * H, generator=g) * 0.1
    b = torch.randn(4 * H, generator=g) * 0.1
    return [t.to(device="cuda", dtype=dtype).contiguous()
            for t in (x, h, c, w, b)]


def cell_bound_ms(B, Din, H, elem_bytes):
    """Least time for one cell step: each input read once, each output
    written once, over HBM; the gate product and gate math over fp32 peak."""
    moved = elem_bytes * (B * Din + 2 * B * H + (Din + H) * 4 * H + 4 * H
                          + 2 * B * H)
    ops = 2 * B * (Din + H) * 4 * H + 4 * B * H + 12 * B * H
    return max(moved / PEAK_BYTES_S, ops / PEAK_FP32_FLOP_S) * 1e3, \
        "bytes" if moved / PEAK_BYTES_S >= ops / PEAK_FP32_FLOP_S else \
        "operations"


def phase_kernel(torch, K, ref):
    """Kernel vs plain version over the sweep and the paper shapes; times at
    the paper shapes. Returns the numbers of the kernel line."""
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.data.text import CharVocab, repo_corpus

    vocab = CharVocab.from_text(repo_corpus()).size
    H = CONFIG.d_model
    paper = [(8, vocab, H), (8, H, H)]          # layer 0, layer 1
    worst = 0.0
    for B, Din, Hh in SWEEP + paper:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            args = cell_inputs(torch, B, Din, Hh, dtype, seed=B * 1000 + Din)
            hk, ck = K.lstm_cell(*args)
            hp, cp = ref.lstm_cell(*args)
            torch.cuda.synchronize()
            tol = TOL[name]
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in ((hk, hp), (ck, cp)))
            ok = all(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)
                     for a, b in ((hk, hp), (ck, cp)))
            print(f"[kernel] lstm_cell B={B} Din={Din} H={Hh} {name}: "
                  f"max|kernel-plain|={err:.3e} tol={tol} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"lstm_cell disagrees with its plain version at "
                      f"B={B} Din={Din} H={Hh} {name}")
            if name == "float32" and (B, Din, Hh) in paper:
                worst = max(worst, err)

    rows = []
    for B, Din, Hh in paper:
        x, h, c, w, b = cell_inputs(torch, B, Din, Hh, torch.float32, seed=7)
        w_ih, w_hh = w[:Din].t().contiguous(), w[Din:].t().contiguous()
        b_hh = torch.zeros_like(b)
        ms = median_ms(lambda: K.lstm_cell(x, h, c, w, b), torch)
        plain_ms = median_ms(lambda: ref.lstm_cell(x, h, c, w, b), torch)
        lib_ms = median_ms(
            lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh), torch)
        bound, by = cell_bound_ms(B, Din, Hh, 4)
        print(f"[kernel] lstm_cell time B={B} Din={Din} H={Hh} fp32: "
              f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"torch.lstm_cell {lib_ms:.5f} ms, bound {bound:.6f} ms "
              f"({by})")
        rows.append(dict(shape=[B, Din, Hh], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by))
    return worst, rows


# the six leaves of the paper's gradient (head b, head w, layer 0 bias and
# kernel, layer 1 bias and kernel), their element counts before padding
PAPER_LEAVES = [95, 4750, 200, 29000, 200, 20000]
TERNARY_SWEEP = [4, 128, 4096, 10000]      # tests/test_kernels.py


def ternary_bound_ms(n):
    """Least time for one encode or decode of n (padded) elements: fp32
    [n] and uint8 [n/4] and the scale each crossed once at HBM rate; the
    ~4 operations per element (abs, compare, select, shift-or) at fp32
    peak."""
    moved = 4 * n + n // 4 + 4
    ops = 4 * n
    t_b, t_o = moved / PEAK_BYTES_S, ops / PEAK_FP32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def planted_leaf(torch, n, seed, s=None):
    """A padded leaf of n values with the threshold's edge planted: s
    itself first (so it is the max), then s/2, its two float neighbours and
    their negatives. ``s`` given (a power of two, say) scales the leaf to
    it."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g)
    n4 = -(-n // 4) * 4
    x = torch.cat([x, torch.zeros(n4 - n)])
    scale = torch.tensor(float(s) if s is not None else 1.7, dtype=torch.float32)
    x = (x / x.abs().max() * scale * 0.999).float()
    half = scale / 2
    edge = torch.stack([half, torch.nextafter(half, torch.tensor(0.0)),
                        torch.nextafter(half, torch.tensor(float("inf")))])
    plant = torch.cat([scale.reshape(1), edge, -edge])
    k = min(len(plant), n)
    x[:k] = plant[:k]
    return x


def bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality of two fp32 tensors (+0.0 and -0.0 differ)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def phase_ternary(torch, T, ref):
    """ternary_encode byte for byte and ternary_decode bit for bit against
    their plain versions; times at the paper's largest leaf."""
    cases = [(f"sweep N={n}", planted_leaf(torch, n, seed=n)) for n in
             TERNARY_SWEEP]
    cases += [(f"paper leaf n={n}", planted_leaf(torch, n, seed=7 + i))
              for i, n in enumerate(PAPER_LEAVES)]
    cases += [(f"paper leaf n={n} s=2.0", planted_leaf(torch, n, seed=11,
                                                       s=2.0))
              for n in (95, 29000)]
    worst = {"enc": 0, "dec": 0.0}
    for name, x in cases:
        g = x.cuda()
        s = torch.clamp_min(g.abs().max(), 1e-12)
        pk, pp = T.ternary_encode(g, s), ref.ternary_encode_packed(g, s)
        dk, dp = T.ternary_decode(pk, s), ref.ternary_decode_packed(pk, s)
        torch.cuda.synchronize()
        enc_ok = torch.equal(pk, pp)
        dec_ok = bits_equal(torch, dk, dp)
        worst["enc"] = max(worst["enc"], (pk.int() - pp.int()).abs()
                           .max().item())
        worst["dec"] = max(worst["dec"], (dk - dp).abs().max().item())
        print(f"[kernel] ternary {name}: encode bytes equal {enc_ok}, "
              f"decode bits equal {dec_ok}, {int((pk != 0).sum())} nonzero "
              f"bytes")
        check(enc_ok, f"ternary_encode differs from its plain version "
                      f"({name})")
        check(dec_ok, f"ternary_decode differs from its plain version "
                      f"({name})")
    # every byte value, codes 0b11 included, decodes as the plain version
    every = torch.arange(256, dtype=torch.uint8, device="cuda")
    s = torch.tensor(0.37, device="cuda")
    ok = bits_equal(torch, T.ternary_decode(every, s),
                    ref.ternary_decode_packed(every, s))
    print(f"[kernel] ternary_decode of all 256 byte values bit-equal: {ok}")
    check(ok, "ternary_decode differs from its plain version on some byte")

    n = max(PAPER_LEAVES)
    g = planted_leaf(torch, n, seed=3).cuda()
    s = g.abs().max()
    pk = T.ternary_encode(g, s)
    bound, by = ternary_bound_ms(n)
    rows = {}
    for key, kern, plain in (
            ("encode", lambda: T.ternary_encode(g, s),
             lambda: ref.ternary_encode_packed(g, s)),
            ("decode", lambda: T.ternary_decode(pk, s),
             lambda: ref.ternary_decode_packed(pk, s))):
        ms = median_ms(kern, torch)
        plain_ms = median_ms(plain, torch)
        print(f"[kernel] ternary_{key} time N={n} fp32: kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, no one-call PyTorch equivalent, "
              f"bound {bound:.6f} ms ({by})")
        rows[key] = dict(n=n, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by)
    rows["encode"]["max_abs_err"] = worst["enc"]
    rows["decode"]["max_abs_err"] = worst["dec"]
    return rows


def plain_loss(torch, ref, params, batch):
    """lstm_loss with every cell step in the plain version (autograd
    differentiates it directly): the reference for the gradient phase."""
    import torch.nn.functional as F
    xs = batch["x"].transpose(0, 1)
    for lp in params["layers"]:
        Hh = lp["kernel"].shape[1] // 4
        h = torch.zeros(xs.shape[1], Hh, device=xs.device)
        c = torch.zeros_like(h)
        hs = []
        for x in xs:
            h, c = ref.lstm_cell(x, h, c, lp["kernel"], lp["bias"])
            hs.append(h)
        xs = torch.stack(hs)
    logits = xs[-1] @ params["head"]["w"] + params["head"]["b"]
    logp = torch.log_softmax(logits, dim=-1)
    y = F.one_hot(batch["y"].long(), logp.shape[-1]).to(logp.dtype)
    return -(logp * y).sum(-1).mean()


def phase_grad(torch, ref):
    from repro_torch import tree
    from repro_torch.core.mapreduce import TrainingProblem

    prob = TrainingProblem.paper_problem(seed=0, device="cuda")
    batch = prob.minibatch(0, 0)
    loss_k, grads_k = prob.loss_and_grads(prob.params0, batch)
    leaves, spec = tree.flatten(prob.params0)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    loss_p = plain_loss(torch, ref, tree.unflatten(spec, leaves), b)
    grads_p = torch.autograd.grad(loss_p, leaves)
    torch.cuda.synchronize()
    err = max([abs(loss_k.item() - loss_p.item())] +
              [(a - b).abs().max().item()
               for a, b in zip(tree.leaves(grads_k), grads_p)])
    ok = torch.allclose(loss_k, loss_p.detach(), rtol=GRAD_TOL,
                        atol=GRAD_TOL) and all(
        torch.allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
        for a, b in zip(tree.leaves(grads_k), grads_p))
    print(f"[grad] lstm_loss d_model={prob.cfg.d_model} vocab="
          f"{prob.cfg.vocab}: loss {loss_k.item():.6f}, max|kernel-plain| "
          f"over loss and grads {err:.3e} tol={GRAD_TOL} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "kernel-forward gradients disagree with the plain path")


def reset_counts(K, T):
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    for fn in (K.lstm_cell, T.ternary_encode, T.ternary_decode, RN.rmsnorm,
               FA.flash_attention):
        fn.launches = 0


def same_model(torch, res, ref_params, ref_state) -> bool:
    """The run's (params, opt_state) equal the reference's bit for bit."""
    from repro_torch import tree
    return all(a.dtype == b.dtype and (
        bits_equal(torch, a, b) if a.dtype == torch.float32
        else torch.equal(a, b)) for a, b in
        zip(tree.leaves((res.params, res.opt_state)),
            tree.leaves((ref_params, ref_state)), strict=True))


def phase_codec(torch):
    """The ternary codec's error-feedback chain on the card against the same
    chain on the CPU, from the same three paper-width map gradients: the
    decoded gradients, the residuals and the byte counts must be equal bit
    for bit (the encode/decode kernels against their plain versions, inside
    the codec)."""
    from repro_torch import tree
    from repro_torch.core.mapreduce import TrainingProblem
    from repro_torch.optim import ef_compress, ef_init, make_codec

    prob = TrainingProblem.paper_problem(seed=0, device="cuda")
    codec = make_codec("ternary")
    r_gpu, r_cpu = ef_init(prob.params0), ef_init(tree.to_device(
        prob.params0, "cpu"))
    for mb in range(3):
        g, _ = prob.map_compute(prob.params0, 0, mb)
        d_gpu, r_gpu, n_gpu = ef_compress(codec, g, r_gpu)
        d_cpu, r_cpu, n_cpu = ef_compress(codec, tree.to_device(g, "cpu"),
                                          r_cpu)
        torch.cuda.synchronize()
        same = all(bits_equal(torch, a.cpu(), b) for a, b in zip(
            tree.leaves((d_gpu, r_gpu)), tree.leaves((d_cpu, r_cpu)),
            strict=True))
        print(f"[codec] ternary ef_compress step {mb + 1}: decoded and "
              f"residual card == cpu bit for bit: {same}; nbytes "
              f"{n_gpu} (cpu {n_cpu}, dense {prob.grad_bytes})")
        check(same, f"ternary codec step {mb + 1} differs between the card "
                    f"and the CPU")
        check(n_gpu == n_cpu == TERNARY_GRAD_BYTES,
              f"ternary nbytes {n_gpu}/{n_cpu}, expected "
              f"{TERNARY_GRAD_BYTES}")


def phase_main_path(torch, K, T):
    from repro_torch.core.mapreduce import TrainingProblem, sequential_accumulated
    from repro_torch.launch.train import run_paper

    workers, versions = 3, 3
    reset_counts(K, T)
    t0 = time.time()
    prob, res = run_paper(workers=workers, versions=versions, seed=0,
                          device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = K.lstm_cell.launches
    maps = sum(res.tasks_by_worker.values()) - versions
    print(f"[main] Coordinator workers={workers} versions={versions}: "
          f"{dt / versions:.3f} s per version, {maps} maps, "
          f"{launches} lstm_cell launches, losses {res.losses}")
    check(res.final_version == versions,
          f"final version {res.final_version}, expected {versions}")
    check(all(math.isfinite(l) for l in res.losses), "non-finite loss")
    check(maps == versions * prob.tp.mini_batches_to_accumulate,
          f"{maps} maps ran, expected "
          f"{versions * prob.tp.mini_batches_to_accumulate}")
    check(launches == prob.cell_launches_per_map * maps,
          f"{launches} kernel launches, expected "
          f"{prob.cell_launches_per_map} x {maps}")

    check(T.ternary_encode.launches == T.ternary_decode.launches == 0,
          "the dense path launched a ternary kernel")
    p_seq, s_seq, l_seq = sequential_accumulated(prob, n_versions=versions)
    same = same_model(torch, res, p_seq, s_seq)
    print(f"[main] Coordinator == sequential_accumulated on the card, bit for "
          f"bit: {same}")
    check(same, "Coordinator run on the card differs from "
                "sequential_accumulated on the card")

    prob_cpu = TrainingProblem.paper_problem(seed=0, device="cpu")
    _, _, l_cpu = sequential_accumulated(prob_cpu, n_versions=versions)
    diff = max(abs(a - b) for a, b in zip(res.losses, l_cpu, strict=True))
    print(f"[main] per-version losses card {res.losses} vs cpu {l_cpu}: "
          f"max diff {diff:.3e} tol={CPU_LOSS_TOL}")
    check(diff <= CPU_LOSS_TOL, "card and CPU loss trajectories differ")
    return prob, launches, (p_seq, s_seq), dt / versions


def phase_wire_paths(torch, K, T, prob, seq, dense_s):
    """The gradient wire: dense over the wire, TernGrad over the wire and in
    process, and a short top-k run, each through ``run_paper`` with every
    count set to 0 just before and read just after, and held to its path."""
    from repro_torch.launch.train import run_paper

    workers, versions = 3, 3
    n_mb = prob.tp.mini_batches_to_accumulate
    maps = versions * n_mb

    def run(codec, transport, w=workers, v=versions):
        reset_counts(K, T)
        t0 = time.time()
        _, res = run_paper(workers=w, versions=v, seed=0, device="cuda",
                           codec=codec, transport=transport)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = (K.lstm_cell.launches, T.ternary_encode.launches,
                  T.ternary_decode.launches)
        tag = f"{codec}/{transport}"
        check(res.final_version == v, f"{tag}: final version "
                                      f"{res.final_version}, expected {v}")
        check(all(math.isfinite(l) for l in res.losses),
              f"{tag}: non-finite loss")
        n_maps = sum(res.tasks_by_worker.values()) - v
        check(n_maps == v * n_mb, f"{tag}: {n_maps} maps, expected "
                                  f"{v * n_mb}")
        per_leaf = PAPER_N_LEAVES * n_maps if codec == "ternary" else 0
        want = (prob.cell_launches_per_map * n_maps, per_leaf, per_leaf)
        check(counts == want, f"{tag}: launches lstm_cell/encode/decode "
                              f"{counts}, expected {want}")
        check((res.wire_bytes is not None) == (transport == "wire"),
              f"{tag}: wire_bytes {res.wire_bytes}")
        print(f"[wire] codec={codec} transport={transport}: "
              f"{dt / v:.3f} s per version (dense inproc {dense_s:.3f}), "
              f"launches lstm_cell/encode/decode {counts} (expected), "
              f"codec bytes_sent {res.bytes_sent}, wire_bytes "
              f"{res.wire_bytes}, losses {res.losses}")
        return res, counts, dt / v

    dense_wire, _, dense_wire_s = run("none", "wire")
    same = same_model(torch, dense_wire, *seq)
    print(f"[wire] dense wire run == sequential_accumulated on the card, bit "
          f"for bit: {same}")
    check(same, "dense wire run differs from sequential_accumulated")

    tern_wire, counts, tern_wire_s = run("ternary", "wire")
    want = maps * TERNARY_GRAD_BYTES + versions * prob.model_bytes
    print(f"[wire] ternary codec bytes_sent {tern_wire.bytes_sent} = {maps} "
          f"maps x {TERNARY_GRAD_BYTES} + {versions} reduces x "
          f"{prob.model_bytes} (dense gradients would count "
          f"{prob.grad_bytes} each): {tern_wire.bytes_sent == want}")
    check(tern_wire.bytes_sent == want, f"ternary bytes_sent "
                                        f"{tern_wire.bytes_sent}, want {want}")
    wire_bytes = {"none/wire": dense_wire.wire_bytes,
                  "ternary/wire": tern_wire.wire_bytes}
    print(f"[wire] bytes the wire moved (requests, replies, notifications): "
          f"dense {dense_wire.wire_bytes}, ternary {tern_wire.wire_bytes} "
          f"(the gradient crosses decoded; ratio "
          f"{tern_wire.wire_bytes / dense_wire.wire_bytes:.4f})")

    tern_inproc, _, tern_inproc_s = run("ternary", "inproc")
    same = same_model(torch, tern_wire, tern_inproc.params,
                      tern_inproc.opt_state)
    print(f"[wire] ternary wire run == ternary inproc run, bit for bit: "
          f"{same}")
    check(same, "the wire changed the ternary run's model")

    run("topk", "inproc", w=2, v=1)

    # the four paths once more in the reverse order, for time only, so each
    # path's seconds per version is a mean over an early and a late slot
    first = {"ternary/inproc": tern_inproc_s, "ternary/wire": tern_wire_s,
             "none/wire": dense_wire_s, "none/inproc": dense_s}
    per_version = {}
    for key, s1 in first.items():
        _, _, s2 = run(*key.split("/"))
        per_version[key] = dict(runs=[s1, s2], mean=(s1 + s2) / 2)
    base = per_version["none/inproc"]["mean"]
    for key, row in per_version.items():
        print(f"[wire] {key}: {row['mean']:.3f} s per version (runs "
              f"{row['runs'][0]:.3f}, {row['runs'][1]:.3f}), "
              f"{100 * (row['mean'] / base - 1):+.1f}% against dense inproc")
    return counts, per_version, wire_bytes


def profiled(torch, fn):
    """Run ``fn`` once under ``torch.profiler``: (window ms on the host
    clock, device busy ms, kernel count, {kernel name: (launches, ms)},
    [(host op or runtime call, calls, self host ms)] by self time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()       # the window holds fn's work alone
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    host = sorted(((a.key, a.count, a.self_cpu_time_total / 1e3)
                   for a in prof.key_averages()), key=lambda r: -r[2])
    return window_ms, busy_ms, len(kernels), by_name, host


def per_launch_ms(by_name, fragment):
    hits = [(n, t) for name, (n, t) in by_name.items() if fragment in name]
    return sum(t for _, t in hits) / sum(n for n, _ in hits) if hits else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.5f} ms"


def phase_profile(torch, prob):
    """Where the time goes on the card: one map's wall time without and
    with ``torch.profiler``, the device's busy share inside the profiled
    window and the kernels that fill it; then the same for one ternary
    error-feedback round trip of a paper gradient. Runs after the launch
    counts were read, so its launches are not the main paths'."""
    from repro_torch.optim import ef_compress, ef_init, make_codec

    params = prob.params0
    walls = []
    for mb in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob.map_compute(params, 0, mb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    map_ms = statistics.median(walls[1:])
    window_ms, busy_ms, n_kernels, by_name, _ = profiled(
        torch, lambda: prob.map_compute(params, 0, 0))
    print(f"[profile] one map (B=8, T=40): {map_ms:.3f} ms wall (median of "
          f"5, no profiler); profiled window {window_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}%), "
          f"{n_kernels} kernels")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {t:.3f} ms in {n} x {name[:90]}")
    cell_ms = per_launch_ms(by_name, "lstm_cell_kernel")
    print(f"[profile] lstm_cell kernel device time per launch: "
          f"{fmt_ms(cell_ms)}")

    codec = make_codec("ternary")
    grads, _ = prob.map_compute(params, 0, 0)
    residual = ef_init(params)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ef_compress(codec, grads, residual)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    codec_ms = statistics.median(walls[1:])
    window_ms, busy_ms, n_kernels, by_name, _ = profiled(
        torch, lambda: ef_compress(codec, grads, residual))
    enc_ms = per_launch_ms(by_name, "ternary_encode_kernel")
    dec_ms = per_launch_ms(by_name, "ternary_decode_kernel")
    print(f"[profile] one ternary ef_compress of a paper gradient: "
          f"{codec_ms:.3f} ms wall (median of 5, no profiler); profiled "
          f"window {window_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / window_ms:.1f}%), {n_kernels} kernels; device "
          f"time per launch: ternary_encode {fmt_ms(enc_ms)}, "
          f"ternary_decode {fmt_ms(dec_ms)}")
    return dict(map_ms=map_ms, cell_ms=cell_ms, codec_ms=codec_ms,
                enc_ms=enc_ms, dec_ms=dec_ms)

# ---------------------------------------------------------------------------
# the dense transformer serving path (qwen1.5-110b at full width, 4 layers)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOP_S = 989e12          # H100 SXM tensor cores, dense bf16

# tests/test_kernels.py's sweeps; rmsnorm's last two have rows that are not
# 16-byte aligned (the kernel's one-element-at-a-time path)
RMS_SWEEP = [(4, 64), (2, 17, 256), (1, 3, 5, 128), (3, 129), (2, 130)]
FLASH_SWEEP = [(1, 64, 4, 4, 32), (2, 129, 8, 4, 64), (1, 200, 8, 1, 16)]
FLASH_MASKS = [(True, 0), (True, 37), (False, 0)]
# tests/test_kernels.py::test_flash_attention_sweep (fp32)
FLASH_RTOL, FLASH_ATOL = 5e-5, 5e-6
# at the qwen prefill shape in bf16: both paths compute in fp32 from the same
# bf16 inputs and round once to bf16, so they differ by at most one bf16 ulp
# (<= 2^-7 of |out|, inside the rtol of _tol); the atol is cut from _tol's
# 2e-2 to 5e-4, below the ~3e-3 a dropped 32-key tile moves a long row's
# output (|out| ~ 0.02 there: near-uniform softmax over ~500 values), so
# only rows of tiny output escape the relative bound
QWEN_FLASH_BF16_ATOL = 5e-4
# the qwen prefill shape's inputs: x0.5 (score std 0.25, near-uniform
# softmax, the timed inputs) and x2 (score std 4, peaked: the online
# softmax's running max moves and rescales the accumulator tile after tile)
QWEN_FLASH_SCALES = (0.5, 2.0)
# fp32 at x2 is held against the exact (fp64) attention instead: there one
# ulp of a score near 20 (1.9e-6) moves its probability by as much,
# relative, and |v| up to ~8 carries that to a few 1e-5, above the sweep's
# atol, which was set at unit-size inputs. The kernel must stay within this
# factor of the plain fp32 version's own distance from the exact result; a
# dropped tile or a wrong rescale moves it by orders of magnitude more
QWEN_FLASH_EXACT_FACTOR = 4.0

SERVE_ARCH, SERVE_LAYERS = "qwen1.5-110b", 4            # 80 -> 4 layers
SERVE = dict(requests=8, batch=4, prompt=1024, tokens=16, seed=0)
SERVE_PARAMS = 7_927_349_248
# kernel path against the plain path, same weights, same tokens, on the
# card: max|kernel - plain| over a batch's logits at most this share of its
# max|logit|. The error is noise spread over the whole logit vector, not a
# per-element relative error: in bf16 every rounding of an activation that
# the two paths compute in another order (norm sums, attention sums) moves
# later layers, and two plain versions of the same math (ref.rmsnorm and
# F.rms_norm) differ by as much (~1.2% of max|logit| at 4 layers, printed
# beside every check). bf16: the 2e-2 of tests/test_kernels.py::_tol; fp32
# (the same model in fp32, where the noise is ~1e-5): 1e-4
SERVE_LOGIT_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SERVE_FP32 = dict(batch=4, prompt=512, tokens=6)
# card against CPU at smoke size, fp32: the same math summed in other
# orders (cuBLAS, the kernels' trees) on logits of size ~0.6
SMOKE_LOGIT_TOL = 1e-4


def randn(torch, shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)


def held(torch, name, got, want, rtol, atol) -> float:
    """Max |got - want|; fails unless allclose at (rtol, atol)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    print(f"[kernel] {name}: max|kernel-plain|={err:.3e} rtol={rtol} "
          f"atol={atol} {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def exact_causal_attention(torch, q, k, v):
    """Causal GQA attention in fp64 (query head h reads kv head h // G):
    the exact result the fp32 kernel and plain version are measured from."""
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.double().reshape(B, S, Kv, H // Kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()) / math.sqrt(hd)
    ok = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.double()) \
        .reshape(B, S, H, hd)


def held_exact(torch, name, got, plain, exact) -> float:
    """Fails unless max|got - exact| is within QWEN_FLASH_EXACT_FACTOR of
    max|plain - exact|. Returns max|got - plain|."""
    torch.cuda.synchronize()
    err = (got.double() - exact).abs().max().item()
    floor = (plain.double() - exact).abs().max().item()
    diff = (got.double() - plain.double()).abs().max().item()
    ok = err <= QWEN_FLASH_EXACT_FACTOR * floor
    print(f"[kernel] {name}: max|kernel-exact|={err:.3e}, max|plain-exact|="
          f"{floor:.3e}, max|kernel-plain|={diff:.3e}; kernel within "
          f"{QWEN_FLASH_EXACT_FACTOR} x plain's distance "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel farther from the exact attention than its "
              f"plain version's rounding")
    return diff


def rms_bound_ms(rows, d, elem_bytes):
    """x read once, y written once, scale read once; ~4 flops an element
    at the fp32 rate."""
    moved = elem_bytes * (2 * rows * d + d)
    t_b, t_o = moved / PEAK_BYTES_S, 4 * rows * d / PEAK_FP32_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def flash_bound_ms(B, S, H, Kv, hd, elem_bytes):
    """The causal pairs' two products (S(S+1)/2 pairs a head, 2 flops a
    multiply-add) at the bf16 tensor-core rate; q, k, v and out each
    crossed once."""
    flops = 4 * B * H * hd * S * (S + 1) // 2
    moved = elem_bytes * (2 * B * S * H * hd + 2 * B * S * Kv * hd)
    t_b, t_o = moved / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def phase_rmsnorm(torch, RN, ref):
    """rmsnorm against its plain version over the JAX sweep and the serve
    path's shapes; times at those shapes beside the plain version,
    ``F.rms_norm`` and the bound."""
    import torch.nn.functional as F
    for i, shape in enumerate(RMS_SWEEP):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            x = randn(torch, shape, dtype, seed=i)
            s = randn(torch, shape[-1:], dtype, seed=100 + i)
            held(torch, f"rmsnorm {shape} {name}", RN.rmsnorm(x, s),
                 ref.rmsnorm(x, s), TOL[name], TOL[name])
    rows = {}
    worst = 0.0
    d = 8192
    for key, n_rows in (("prefill", SERVE["batch"] * SERVE["prompt"]),
                        ("decode", SERVE["batch"])):
        x = randn(torch, (n_rows, d), torch.bfloat16, seed=7)
        s = randn(torch, (d,), torch.bfloat16, seed=8)
        worst = max(worst, held(torch, f"rmsnorm qwen {key} [{n_rows}, {d}] "
                                f"bfloat16", RN.rmsnorm(x, s),
                                ref.rmsnorm(x, s), TOL["bfloat16"],
                                TOL["bfloat16"]))
        ms = median_ms(lambda: RN.rmsnorm(x, s), torch)
        plain_ms = median_ms(lambda: ref.rmsnorm(x, s), torch)
        lib_ms = median_ms(lambda: F.rms_norm(x, (d,), s, 1e-6), torch)
        bound, by = rms_bound_ms(n_rows, d, 2)
        print(f"[kernel] rmsnorm time [{n_rows}, {d}] bf16: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, F.rms_norm "
              f"{lib_ms:.5f} ms, bound {bound:.6f} ms ({by})")
        rows[key] = dict(shape=[n_rows, d], ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
    return worst, rows


def sdpa(torch, q, k, v):
    """The one-call PyTorch operator on q [B,S,H,hd], k/v [B,S,Kv,hd]
    (causal, GQA), for comparison only."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)


def phase_flash(torch, FA, ref):
    """flash_attention against its plain version over the JAX sweep (fp32
    at the sweep's tolerance, bf16 at _tol) and at the qwen prefill shape
    (bf16 at _tol's rtol and QWEN_FLASH_BF16_ATOL; fp32 at the sweep's
    tolerance, and with a peaked softmax against the exact attention);
    times there beside the plain version, SDPA and the bound."""
    for i, (B, S, H, Kv, hd) in enumerate(FLASH_SWEEP):
        for causal, window in FLASH_MASKS:
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                q, k, v = (randn(torch, (B, S, n, hd), dtype, 10 * i + j, 0.5)
                           for j, n in enumerate((H, Kv, Kv)))
                rtol, atol = (FLASH_RTOL, FLASH_ATOL) if name == "float32" \
                    else (TOL[name], TOL[name])
                held(torch, f"flash_attention B={B} S={S} H={H} Kv={Kv} "
                     f"hd={hd} causal={causal} window={window} {name}",
                     FA.flash_attention(q, k, v, causal=causal, window=window),
                     ref.flash_attention(q, k, v, causal=causal,
                                         window=window), rtol, atol)
    B, S, H, Kv, hd = SERVE["batch"], SERVE["prompt"], 64, 8, 128
    worst = 0.0
    for scale in QWEN_FLASH_SCALES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v = (randn(torch, (B, S, n, hd), dtype, 50 + j, scale)
                       for j, n in enumerate((H, Kv, Kv)))
            tag = (f"flash_attention qwen prefill B={B} S={S} H={H} "
                   f"Kv={Kv} hd={hd} causal inputs x{scale} {name}")
            if name == "float32" and scale > 1:
                held_exact(torch, tag, FA.flash_attention(q, k, v),
                           ref.flash_attention(q, k, v),
                           exact_causal_attention(torch, q, k, v))
                continue
            rtol, atol = (FLASH_RTOL, FLASH_ATOL) if name == "float32" \
                else (TOL[name], QWEN_FLASH_BF16_ATOL)
            err = held(torch, tag, FA.flash_attention(q, k, v),
                       ref.flash_attention(q, k, v), rtol, atol)
            if name == "bfloat16":
                worst = max(worst, err)
    q, k, v = (randn(torch, (B, S, n, hd), torch.bfloat16, 50 + j,
                     QWEN_FLASH_SCALES[0]) for j, n in enumerate((H, Kv, Kv)))
    ms = median_ms(lambda: FA.flash_attention(q, k, v), torch, reps=10,
                   inner=3)
    plain_ms = median_ms(lambda: ref.flash_attention(q, k, v), torch,
                         reps=10, inner=3)
    # SDPA picks kernels that deterministic mode may refuse: off for it only
    torch.use_deterministic_algorithms(False)
    try:
        lib = sdpa(torch, q, k, v)
        lib_err = (lib().float() - ref.flash_attention(q, k, v).float()) \
            .abs().max().item()
        lib_ms = median_ms(lib, torch, reps=10, inner=3)
    finally:
        torch.use_deterministic_algorithms(True)
    bound, by = flash_bound_ms(B, S, H, Kv, hd, 2)
    print(f"[kernel] flash_attention time B={B} S={S} H={H} Kv={Kv} "
          f"hd={hd} causal bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA {lib_ms:.4f} ms (max|SDPA-plain| {lib_err:.3e}), bound "
          f"{bound:.5f} ms ({by})")
    return worst, dict(shape=[B, S, H, Kv, hd], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by)


def plain_kernels(rmsnorm=None):
    """Route the model's kernel calls to the plain versions, on any device,
    for the ``with`` block (the comparison runs of the serve phase);
    ``rmsnorm`` replaces the plain RMSNorm (the noise-floor run)."""
    import contextlib
    from unittest import mock
    from repro_torch.kernels import ops, ref
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ops, "rmsnorm",
                                          rmsnorm or ref.rmsnorm))
    stack.enter_context(mock.patch.object(ops, "flash_attention",
                                          ref.flash_attention))
    return stack


def teacher_forced(torch, M, params, cfg, prompt_toks, gen_toks):
    """Prefill, then decode fed ``gen_toks`` [B, T] (the served tokens):
    the logits of the prefill and of each decode step, [T, B, V]."""
    B, P = prompt_toks.shape
    T = gen_toks.shape[1]
    cache = M.init_cache(cfg, B, P + T + 8, device="cuda")
    logits, cache = M.prefill(params, cfg, {"tokens": prompt_toks},
                              cache)
    out = [logits]
    for t in range(T - 1):
        logits, cache = M.decode_step(params, cfg, gen_toks[:, t], cache,
                                      P + t)
        out.append(logits)
    return torch.stack(out)


def lib_rmsnorm(x, scale, eps=1e-6):
    import torch.nn.functional as F
    return F.rms_norm(x, (x.shape[-1],), scale, eps)


def hold_logits(torch, M, params, cfg, prompt_toks, gen_toks, tag):
    """The kernel path, the plain path and the plain path with
    ``F.rms_norm`` (the noise floor), teacher-forced on ``gen_toks``;
    fails unless kernel vs plain is within SERVE_LOGIT_TOL of the logits'
    scale. Returns (max|kernel-plain|, the kernel path's tokens agree)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import greedy
    with torch.no_grad():
        kern = teacher_forced(torch, M, params, cfg, prompt_toks,
                              gen_toks)
        before = (RN.rmsnorm.launches, FA.flash_attention.launches)
        with plain_kernels():
            plain = teacher_forced(torch, M, params, cfg, prompt_toks,
                                   gen_toks)
        with plain_kernels(rmsnorm=lib_rmsnorm):
            floor = teacher_forced(torch, M, params, cfg, prompt_toks,
                                   gen_toks)
        check((RN.rmsnorm.launches, FA.flash_attention.launches) == before,
              "a plain run launched a kernel")
    torch.cuda.synchronize()
    err = (kern - plain).abs().max().item()
    noise = (floor - plain).abs().max().item()
    scale = plain.abs().max().item()
    tol = SERVE_LOGIT_TOL[cfg.dtype]
    ok = err <= tol * scale
    print(f"[serve] {tag}: prefill + {gen_toks.shape[1] - 1} decode steps, "
          f"logits max|kernel-plain| {err:.3e}, max|plain-plain with "
          f"F.rms_norm| {noise:.3e}, max|logit| {scale:.3f}; tol "
          f"{tol} x max|logit| = {tol * scale:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, f"serve logits ({tag}): kernel path disagrees with the plain "
              f"path")
    return err, torch.equal(greedy(kern).t(), gen_toks)


def phase_serve(torch, K, T):
    """qwen1.5-110b at full width, cut to 4 layers, served through
    ``repro_torch.launch.serve.serve`` with every count set to 0 just
    before and read just after; then the same weights through the plain
    versions on the card, teacher-forced on the served tokens."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import greedy, make_prompts, serve
    from repro_torch.models import model as M

    cfg = C.get(SERVE_ARCH).replace(n_layers=SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, T)
    t0 = time.perf_counter()
    res = serve(cfg, device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = dict(rmsnorm=RN.rmsnorm.launches,
                  flash_attention=FA.flash_attention.launches,
                  others=K.lstm_cell.launches + T.ternary_encode.launches +
                  T.ternary_decode.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_batches = -(-SERVE["requests"] // SERVE["batch"])
    per_pass = 2 * SERVE_LAYERS + 1
    want = dict(rmsnorm=per_pass * SERVE["tokens"] * n_batches,
                flash_attention=SERVE_LAYERS * n_batches, others=0)
    toks = res["tokens"]
    # per batch: the first includes the first allocations, the last is warm
    prefill_ms = [t * 1e3 for t in res["prefill_s"]]
    decode_ms = [t / (SERVE["tokens"] - 1) * 1e3 for t in res["decode_s"]]
    tok_s = SERVE["requests"] * SERVE["tokens"] / (sum(res["prefill_s"]) +
                                                  sum(res["decode_s"]))
    print(f"[serve] {cfg.name} d_model={cfg.d_model} layers={cfg.n_layers} "
          f"(of 80) bf16, requests={SERVE['requests']} batch="
          f"{SERVE['batch']} prompt={SERVE['prompt']} tokens="
          f"{SERVE['tokens']}: prefill ms per batch "
          f"{', '.join(f'{t:.2f}' for t in prefill_ms)}; decode ms per "
          f"token step {', '.join(f'{t:.3f}' for t in decode_ms)}; "
          f"{tok_s:.1f} tok/s over the run (wall {wall_s:.1f} s with the "
          f"weights' init); peak memory {peak_gb:.2f} GB; launches {counts} "
          f"(expected {want})")
    check(counts == want and res["launches"] == {
        k: v for k, v in want.items() if k != "others"},
        f"serve launches {counts} / {res['launches']}, expected {want}")
    check(tuple(toks.shape) == (SERVE["requests"], SERVE["tokens"]) and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"served tokens {tuple(toks.shape)} out of shape or range")

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), "cuda")
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"[serve] parameters: {n_params:,} ({2 * n_params / 1e9:.1f} GB "
          f"bf16)")
    check(n_params == SERVE_PARAMS, f"{n_params} parameters, expected "
                                    f"{SERVE_PARAMS}")
    prompts = make_prompts(cfg, SERVE["requests"], SERVE["prompt"],
                           SERVE["seed"])
    worst = 0.0
    for b0 in range(0, SERVE["requests"], SERVE["batch"]):
        p = torch.from_numpy(np.stack(prompts[b0:b0 + SERVE["batch"]])).cuda()
        g = toks[b0:b0 + SERVE["batch"]].cuda()
        err, same = hold_logits(torch, M, params, cfg, p, g,
                                f"requests {b0}-{b0 + SERVE['batch'] - 1}")
        check(same, "the kernel path gave other tokens on a second run")
        worst = max(worst, err)
    return dict(counts=counts, prefill_ms=prefill_ms, decode_ms=decode_ms,
                tok_s=tok_s, peak_gb=peak_gb, logit_err=worst,
                params=params, cfg=cfg, prompts=prompts)


def phase_serve_fp32(torch):
    """The same 4-layer model in fp32 (31.7 GB), where rounding noise is
    ~1e-5: a greedy run through the kernels, then kernel vs plain
    teacher-forced on its tokens within 1e-4 of the logits' scale. Holds
    both kernels at full width where bf16 noise cannot hide an error."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.launch.serve import greedy, make_prompts
    from repro_torch.models import model as M

    cfg = C.get(SERVE_ARCH).replace(n_layers=SERVE_LAYERS, dtype="float32")
    B, P, Tn = SERVE_FP32["batch"], SERVE_FP32["prompt"], SERVE_FP32["tokens"]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SERVE["seed"]), "cuda")
    p = torch.from_numpy(np.stack(make_prompts(cfg, B, P, SERVE["seed"]))) \
        .cuda()
    with torch.no_grad():
        cache = M.init_cache(cfg, B, P + Tn + 8, device="cuda")
        logits, cache = M.prefill(params, cfg, {"tokens": p}, cache)
        toks = [greedy(logits)]
        for t in range(Tn - 1):
            logits, cache = M.decode_step(params, cfg, toks[-1], cache,
                                          P + t)
            toks.append(greedy(logits))
    err, _ = hold_logits(torch, M, params, cfg, p, torch.stack(toks, 1),
                         f"fp32, batch {B}, prompt {P}")
    return err


def phase_serve_profile(torch, served):
    """Where a prefill and a decode step spend the card (torch.profiler),
    and each kernel's device time per launch on the serve path. After the
    counts were read."""
    import numpy as np
    from repro_torch.launch.serve import greedy
    from repro_torch.models import model as M

    cfg, params = served["cfg"], served["params"]
    B, P = SERVE["batch"], SERVE["prompt"]
    toks = torch.from_numpy(np.stack(served["prompts"][:B])).cuda()
    state = {}

    def pre():
        cache = M.init_cache(cfg, B, P + SERVE["tokens"] + 8, device="cuda")
        logits, state["cache"] = M.prefill(params, cfg,
                                           {"tokens": toks}, cache)
        state["tok"] = greedy(logits)

    def dec():
        M.decode_step(params, cfg, state["tok"], state["cache"], P)

    out = {}
    with torch.no_grad():
        pre()
        dec()
        for key, fn in (("prefill", pre), ("decode", dec)):
            window_ms, busy_ms, n_kernels, by_name, host = profiled(torch,
                                                                    fn)
            print(f"[profile] one {key} (B={B}, {P} prompt tokens): window "
                  f"{window_ms:.2f} ms, device busy {busy_ms:.2f} ms "
                  f"({100 * busy_ms / window_ms:.1f}%), {n_kernels} kernels")
            for name, (n, t) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])[:6]:
                print(f"[profile]   {t:.3f} ms in {n} x {name[:90]}")
            for name, n, t in host[:8]:
                print(f"[profile]   host: {t:.3f} ms self in {n} x "
                      f"{name[:80]}")
            out[key] = dict(
                window_ms=window_ms, busy_ms=busy_ms,
                rmsnorm_ms=per_launch_ms(by_name, "rmsnorm_kernel"),
                flash_ms=per_launch_ms(by_name, "flash_kernel"))
            print(f"[profile] device time per launch in the {key}: rmsnorm "
                  f"{fmt_ms(out[key]['rmsnorm_ms'])}, flash_attention "
                  f"{fmt_ms(out[key]['flash_ms'])}")
    return out


def phase_smoke_cpu(torch):
    """qwen1.5-110b's smoke config in fp32: the kernel path on the card
    against the plain path on the CPU, from the same weights and prompt,
    prefill + 3 greedy decode steps."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.launch.serve import greedy
    from repro_torch.models import model as M

    cfg = C.get_smoke(SERVE_ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, size=(2, 9)).astype(np.int32))
    runs = {}
    before = (RN.rmsnorm.launches, FA.flash_attention.launches)
    for dev in ("cuda", "cpu"):
        p = tree.to_device(params, dev)
        cache = M.init_cache(cfg, 2, 20, device=dev)
        logits, cache = M.prefill(p, cfg, {"tokens": toks.to(dev)}, cache)
        outs = [logits]
        for t in range(3):
            logits, cache = M.decode_step(p, cfg, greedy(outs[-1]), cache,
                                          9 + t)
            outs.append(logits)
        runs[dev] = torch.stack(outs).cpu()
    launched = (RN.rmsnorm.launches - before[0],
                FA.flash_attention.launches - before[1])
    err = (runs["cuda"] - runs["cpu"]).abs().max().item()
    same = torch.equal(greedy(runs["cuda"]), greedy(runs["cpu"]))
    print(f"[smoke] {cfg.name} smoke fp32, card kernels vs CPU plain: greedy "
          f"tokens equal {same}, logits max|diff| {err:.3e} "
          f"tol={SMOKE_LOGIT_TOL}; card launches rmsnorm/flash {launched} "
          f"(expected (20, 2))")
    check(same and err <= SMOKE_LOGIT_TOL, "card and CPU disagree at smoke "
                                           "size")
    check(launched == (20, 2), f"smoke launches {launched}, expected (20, 2)")



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as D
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import lstm_cell as K
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as RN
    from repro_torch.kernels import ternary as T

    D.resolve("cuda")          # deterministic kernels, before cuBLAS starts
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.time()
    sources = [K.SOURCE, T.SOURCE, RN.SOURCE, FA.SOURCE]
    kbuild.compile_sources(sources)
    for mod in (K, T, RN, FA):
        mod.build()
    print(f"[build] {', '.join(src.name for src in sources)} built (in "
          f"parallel) and loaded in {time.time() - t0:.1f} s")
    for src in sources:
        for line in kbuild.log_path(src).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src.name}: {line.strip()}")

    worst, rows = phase_kernel(torch, K, ref)
    tern = phase_ternary(torch, T, ref)
    rms_err, rms = phase_rmsnorm(torch, RN, ref)
    fa_err, fa = phase_flash(torch, FA, ref)
    phase_grad(torch, ref)
    phase_codec(torch)
    prob, launches, seq, dense_s = phase_main_path(torch, K, T)
    tern_counts, per_version, wire_bytes = phase_wire_paths(
        torch, K, T, prob, seq, dense_s)
    prof = phase_profile(torch, prob)
    served = phase_serve(torch, K, T)
    serve_prof = phase_serve_profile(torch, served)
    del served["params"]
    torch.cuda.empty_cache()
    fp32_err = phase_serve_fp32(torch)
    torch.cuda.empty_cache()
    phase_smoke_cpu(torch)

    layer0 = rows[0]
    kernels = [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:26",
        "launches": launches, "max_abs_err": worst,
        "ms": layer0["ms"], "plain_ms": layer0["plain_ms"],
        "bound_ms": layer0["bound_ms"], "bound_by": layer0["bound_by"],
        "library_ms": layer0["library_ms"], "shape": layer0["shape"],
        "device_ms": prof["cell_ms"], "layer1": rows[1],
        "map_ms": prof["map_ms"],
    }]
    for key, line, n_launch, dev_ms in (
            ("encode", 21, tern_counts[1], prof["enc_ms"]),
            ("decode", 31, tern_counts[2], prof["dec_ms"])):
        r = tern[key]
        kernels.append({
            "name": f"ternary_{key}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ternary.cu",
            "replaces": f"src/repro/kernels/ternary.py:{line}",
            "launches": n_launch, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "n": r["n"], "device_ms": dev_ms,
            "codec_ms": prof["codec_ms"]})
    kernels.append({
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:16",
        "launches": served["counts"]["rmsnorm"], "max_abs_err": rms_err,
        **rms["prefill"],
        "device_ms": serve_prof["prefill"]["rmsnorm_ms"],
        "decode": dict(rms["decode"],
                       device_ms=serve_prof["decode"]["rmsnorm_ms"])})
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": served["counts"]["flash_attention"],
        "max_abs_err": fa_err, **fa,
        "device_ms": serve_prof["prefill"]["flash_ms"]})
    serve_line = {k: served[k] for k in ("prefill_ms", "decode_ms", "tok_s",
                                         "peak_gb", "logit_err")}
    serve_line["fp32_logit_err"] = fp32_err
    serve_line["profile"] = serve_prof
    print(json.dumps({"s_per_version": per_version,
                      "wire_bytes": wire_bytes, "serve": serve_line}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
