"""Time the ternary codec's error feedback on the card, for comparing two
trees of the port in one call.

Run as a file, with the ``src`` directory of the tree to time (this one's,
or an unpacked earlier commit's) and a label:

    python3 src/repro_torch/launch/codec_bench.py src change
    python3 src/repro_torch/launch/codec_bench.py /tmp/parent/src parent

It imports ``repro_torch`` from the given directory, builds its ternary
kernels, and prints one JSON line per gradient: the paper's (one map's
gradient, 6 leaves), one leaf of 2^26 fp32 and 64 leaves of 2^20. Each line
holds ``ef_compress``'s host ms around a call and a synchronize (median of
50), its ms per call over back-to-back calls (CUDA events, median of 20
windows of 10), and its kernels and device busy ms per call under
``torch.profiler`` (10 calls in a window). Where the tree has the
gradient-level wrapper (``kernels/ternary.py::ef_compress_leaves``), the
same two times of that wrapper alone. Run trees in turns (A, B, B, A): two
calls may land on cards with other power limits.
"""
import json
import statistics
import sys
import time

import torch


def host_ms(fn, n=50):
    for _ in range(10):
        fn()
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def event_ms(fn, reps=20, inner=10):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / inner)
    return statistics.median(ts)


def profile(fn, reps=10, tries=3):
    """(kernels, device busy ms, kernel names) per call; a window that
    recorded no device event at all is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ks:
            break
    names = sorted({e.name[:40] for e in ks})
    return len(ks) / reps, sum(e.time_range.elapsed_us() for e in ks) / \
        1e3 / reps, names


def main(src: str, label: str) -> int:
    if not torch.cuda.is_available():
        print("codec_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch import device as D
    from repro_torch import tree
    D.resolve("cuda")
    from repro_torch.core.mapreduce import TrainingProblem
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ternary as T
    from repro_torch.optim import ef_compress, ef_init, make_codec

    kbuild.compile_sources([T.SOURCE])
    T.build()
    codec = make_codec("ternary")
    prob = TrainingProblem.paper_problem(seed=0, device="cuda")
    grads, _ = prob.map_compute(prob.params0, 0, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(n):
        return torch.randn(n, device="cuda", generator=gen)

    trees = {"paper": (grads, ef_init(prob.params0)),
             "1 x 2^26": ({"w": randn(2 ** 26)},
                          {"w": randn(2 ** 26) * 0.01}),
             "64 x 2^20": ({f"l{i:02d}": randn(2 ** 20) for i in range(64)},
                           {f"l{i:02d}": torch.zeros(2 ** 20, device="cuda")
                            for i in range(64)})}
    for name, (g, r) in trees.items():
        def fn():
            return ef_compress(codec, g, r)
        row = dict(label=label, sizes=name, host_ms=host_ms(fn),
                   event_ms=event_ms(fn))
        row["kernels"], row["busy_ms"], row["kernel_names"] = profile(fn)
        if hasattr(T, "ef_compress_leaves"):
            gs, rs = tree.leaves(g), tree.leaves(r)
            row["leaves_host_ms"] = host_ms(
                lambda: T.ef_compress_leaves(gs, rs))
            row["leaves_event_ms"] = event_ms(
                lambda: T.ef_compress_leaves(gs, rs))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(*sys.argv[1:3]))
