"""Training driver of the port: the paper's experiment on the card.

``--paper`` runs the paper's exact experiment — queue-scheduled distributed
training of the 2x50 LSTM on the reference package's own source text (JSDoop
§V), through the Coordinator with K simulated volunteers, each LSTM layer's
forward over the whole sample one launch of the hand-written CUDA sequence
kernel (``lstm_seq``). ``--codec ternary`` puts
each volunteer's gradient through TernGrad with error feedback (two
launches of the hand-written ternary kernels a gradient, on the volunteer:
the scale pass, then codes, decoded gradient and residual) and counts
its packed size in ``bytes_sent``; ``--transport wire`` round-trips every
protocol message through bytes and reports them as ``wire_bytes`` (the
gradient crosses decoded, as in the JAX package). The ``--arch`` path
(sharded transformer training) comes with the port's transformer stack.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --paper --workers 3 --versions 3
  PYTHONPATH=src python -m repro_torch.launch.train --paper --codec ternary --transport wire
  PYTHONPATH=src python -m repro_torch.launch.train --paper --device cpu --versions 1
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.coordinator import Coordinator
from repro_torch.core.mapreduce import TrainingProblem
from repro_torch.kernels import lstm_cell as K
from repro_torch.kernels import ternary as T
from repro_torch.optim import make_codec


def run_paper(*, workers: int = 4, versions: int = 8, seed: int = 0,
              device=None, codec: str = "none", transport: str = "inproc"):
    """Run the Coordinator on the paper problem; returns (problem, result).
    ``device=None`` is the card (raises when there is none). ``codec`` names
    a ``make_codec`` codec ("none" sends dense gradients), ``transport`` is
    "inproc" or "wire"."""
    prob = TrainingProblem.paper_problem(seed=seed, device=device)
    n_versions = versions or prob.n_versions
    print(f"[paper] vocab={prob.cfg.vocab} params={prob.grad_bytes // 4} "
          f"versions={n_versions} workers={workers} device={prob.device} "
          f"codec={codec} transport={transport}")
    seq0, cell0 = K.lstm_seq.launches, K.lstm_cell.launches
    tern0 = (T.ef_compress_leaves.launches, T.ternary_encode.launches,
             T.ternary_decode.launches)
    t0 = time.time()
    coord = Coordinator(prob, n_workers=workers, n_versions=n_versions,
                        codec=None if codec == "none" else make_codec(codec),
                        transport=transport)
    res = coord.run()
    if prob.device.type == "cuda":
        torch.cuda.synchronize(prob.device)
    dt = time.time() - t0
    print(f"[paper] done v{res.final_version} in {dt:.1f}s; "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; "
          f"requeues={res.requeues}")
    maps = sum(res.tasks_by_worker.values()) - n_versions
    print(f"[paper] lstm_seq kernel launches="
          f"{K.lstm_seq.launches - seq0} over {maps} maps "
          f"({prob.seq_launches_per_map} per map, one a layer), lstm_cell "
          f"launches={K.lstm_cell.launches - cell0}; "
          f"ternary ef/encode/decode launches="
          f"{T.ef_compress_leaves.launches - tern0[0]}/"
          f"{T.ternary_encode.launches - tern0[1]}/"
          f"{T.ternary_decode.launches - tern0[2]}; "
          f"bytes_sent={res.bytes_sent}"
          f" wire_bytes={res.wire_bytes}")
    return prob, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--versions", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--codec", default="none",
                    choices=["none", "topk", "ternary"])
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "wire"])
    args = ap.parse_args(argv)
    if not args.paper:
        raise SystemExit("need --paper (the --arch path is not ported yet)")
    run_paper(workers=args.workers, versions=args.versions, seed=args.seed,
              device=args.device, codec=args.codec, transport=args.transport)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
