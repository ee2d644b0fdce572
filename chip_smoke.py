#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its result; any failure exits non-zero:

1. the card's name and power limit, then the build of every kernel of the
   port's main path from the sources in this checkout (timed);
2. each kernel against its plain PyTorch version on the card over the JAX
   package's test sweep and the paper's shapes (fp32 and bf16), and its time
   at the paper's shapes beside the plain version, the one-call PyTorch
   equivalent and the card's bound;
3. the gradient of ``lstm_loss`` at the paper width through the kernel
   against the plain-PyTorch path on the card;
4. the main path: ``repro_torch.launch.train.run_paper`` (3 volunteers, 3
   versions, the Coordinator) on the card, with its kernel launches counted,
   its model bit-equal to ``sequential_accumulated`` on the card, and its
   per-version losses against the same run on the CPU;
5. where one map's time goes: wall time, and a ``torch.profiler`` window's
   device busy share and kernels.

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


def phase_main_path(torch, K):
    from repro_torch import tree
    from repro_torch.core.mapreduce import TrainingProblem, sequential_accumulated
    from repro_torch.launch.train import run_paper

    workers, versions = 3, 3
    K.lstm_cell.launches = 0
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

    p_seq, s_seq, l_seq = sequential_accumulated(prob, n_versions=versions)
    same = all(torch.equal(a, b) for a, b in
               zip(tree.leaves((res.params, res.opt_state)),
                   tree.leaves((p_seq, s_seq)), strict=True))
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
    return prob, launches


def phase_profile(torch, prob):
    """Where one map's time goes on the card: its wall time without and
    with ``torch.profiler``, the device's busy share inside the profiled
    window, and the kernels that fill it. Runs after the launch count was
    read, so its launches are not the main path's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = prob.params0
    walls = []
    for mb in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob.map_compute(params, 0, mb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    map_ms = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prob.map_compute(params, 0, 0)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    print(f"[profile] one map (B=8, T=40): {map_ms:.3f} ms wall (median of "
          f"5, no profiler); profiled window {window_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / window_ms:.1f}%), "
          f"{len(kernels)} kernels")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {t:.3f} ms in {n} x {name[:90]}")
    cell = [(n, t) for name, (n, t) in by_name.items()
            if "lstm_cell_kernel" in name]
    cell_ms = sum(t for _, t in cell) / max(sum(n for n, _ in cell), 1) \
        if cell else None
    print(f"[profile] lstm_cell kernel device time per launch: "
          f"{'not measured' if cell_ms is None else f'{cell_ms:.5f} ms'}")
    return map_ms, cell_ms


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
    from repro_torch.kernels import lstm_cell as K
    from repro_torch.kernels import ref

    D.resolve("cuda")          # deterministic kernels, before cuBLAS starts
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.time()
    K.build()
    print(f"[build] lstm_cell.cu built and loaded in {time.time() - t0:.1f} s")
    for log in sorted(K.BUILD_DIR.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    worst, rows = phase_kernel(torch, K, ref)
    phase_grad(torch, ref)
    prob, launches = phase_main_path(torch, K)
    map_ms, cell_device_ms = phase_profile(torch, prob)

    layer0 = rows[0]
    kernels = [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:26",
        "launches": launches, "max_abs_err": worst,
        "ms": layer0["ms"], "plain_ms": layer0["plain_ms"],
        "bound_ms": layer0["bound_ms"], "bound_by": layer0["bound_by"],
        "library_ms": layer0["library_ms"], "shape": layer0["shape"],
        "device_ms": cell_device_ms, "layer1": rows[1], "map_ms": map_ms,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
