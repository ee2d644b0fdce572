"""Training driver of the port: the paper's experiment and transformer
training on the card.

``--paper`` runs the paper's exact experiment — queue-scheduled distributed
training of the 2x50 LSTM on the reference package's own source text (JSDoop
§V), through the Coordinator with K simulated volunteers, each LSTM layer's
forward over the whole sample one launch of the hand-written CUDA sequence
kernel (``lstm_seq``) and its backpropagation through time one launch of the
backward kernel (``lstm_seq_bwd``). ``--codec ternary`` puts
each volunteer's gradient through TernGrad with error feedback (two
launches of the hand-written ternary kernels a gradient, on the volunteer:
the scale pass, then codes, decoded gradient and residual) and counts
its packed size in ``bytes_sent``; ``--transport wire`` round-trips every
protocol message through bytes and reports them as ``wire_bytes`` (the
gradient crosses decoded, as in the JAX package).

``--arch <id>`` trains any transformer architecture (its smoke config, or
the published one with ``--full``) as ``repro.launch.train --arch`` does:
the same step (``distributed/steps.py``: microbatch gradients summed in an fp32
accumulator, one mean and one optimizer update a step), the same
optimizers, the same random batches (``RandomState(seed)``, one draw a
step: tokens, and an encdec model's ``frames`` or a vlm model's
``patches``), the same checkpoint files (``--ckpt``). Every attention runs the
hand-written flash kernel under autograd (once a layer a microbatch, and
again in the backward under remat), writing its log-sum-exp for the plain
backward; every RMSNorm the ``rmsnorm`` kernel forward and the
``rmsnorm_bwd`` kernel backward; a moe layer's router loss joins the loss
at ``router_aux_weight``; an ssm layer's selective scan runs in plain torch
under autograd; an encdec model's cross-attention runs plain, and its
gradient reaches the encoder. As in the JAX package the step is bound to
the host mesh (``launch/mesh.py::make_host_mesh``): one card, or, under an
initialised process group of N ranks, a ``DeviceMesh`` (N, 1) whose step
shards the parameters and optimizer state and splits each microbatch's
rows over the ranks (``distributed/spmd.py``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --paper --workers 3 --versions 3
  PYTHONPATH=src python -m repro_torch.launch.train --paper --codec ternary --transport wire
  PYTHONPATH=src python -m repro_torch.launch.train --paper --device cpu --versions 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b --full --batch 8 --seq 4096 --micro 8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-110b --device cpu --steps 2 --batch 4 --seq 16 --micro 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b --device cpu --steps 2 --batch 4 --seq 16 --micro 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b --device cpu --steps 1
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base --device cpu --steps 1 --batch 4 --seq 16 --micro 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b --full --batch 8 --seq 4096 --micro 8 --steps 3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import device as D
from repro_torch import tree
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import InputShape
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.mapreduce import TrainingProblem
from repro_torch.distributed import spmd as SP
from repro_torch.distributed import steps as ST
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import lstm_cell as K
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ternary as T
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.runtime import Runtime
from repro_torch.optim import make as make_opt
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
    bwd0 = K.lstm_seq_bwd.launches
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
          f"({prob.seq_launches_per_map} per map, one a layer), "
          f"lstm_seq_bwd launches={K.lstm_seq_bwd.launches - bwd0}, "
          f"lstm_cell launches={K.lstm_cell.launches - cell0}; "
          f"ternary ef/encode/decode launches="
          f"{T.ef_compress_leaves.launches - tern0[0]}/"
          f"{T.ternary_encode.launches - tern0[1]}/"
          f"{T.ternary_decode.launches - tern0[2]}; "
          f"bytes_sent={res.bytes_sent}"
          f" wire_bytes={res.wire_bytes}")
    return prob, res


def arch_config(arch: str, full: bool = False):
    """The config ``--arch`` trains: the published one with ``full``, else
    the smoke config. Raises for the LSTM."""
    cfg = C.get(arch) if full else C.get_smoke(arch)
    if cfg.family == "rnn":
        raise SystemExit("use --paper for the LSTM workload")
    return cfg


def sample_batch(rng, spec, vocab: int, device):
    """One training batch from ``rng``, as ``repro.launch.train`` draws it,
    entry by entry in the spec's order: ``rng.randint(0, vocab,
    size=shape)`` for an integer entry, ``rng.randn(*shape)`` for a float
    one (``frames``, ``patches``), rounded to fp32 and then to the spec's
    dtype, as JAX converts the float64 draw."""
    out = {}
    for k, s in spec.items():
        if s.dtype == torch.int32:
            a = rng.randint(0, vocab, size=s.shape).astype(np.int32)
            out[k] = torch.from_numpy(a).to(device)
        else:
            a = rng.randn(*s.shape).astype(np.float32)
            out[k] = torch.from_numpy(a).to(device=device, dtype=s.dtype)
    return out


def setup_arch(cfg, *, batch: int = 8, seq: int = 64, micro: int = 4,
               lr: float = 1e-3, optimizer: str = "adamw", seed: int = 0,
               remat: bool = True, device=None) -> dict:
    """What a run of ``cfg`` starts from: dict(device, mesh (the host
    mesh), bound (``steps.bind_train`` on it), params (random, from a
    ``torch.Generator`` on the device seeded with ``seed``: every rank
    draws the whole tree, and the first step keeps its shards), opt_state,
    rng (the batches' ``RandomState(seed)``)). ``device=None`` is the card
    (raises when there is none)."""
    dev = D.resolve(device)
    mesh = make_host_mesh(dev)
    opt = make_opt(optimizer, lr)
    bound = ST.bind_train(mesh, cfg, Runtime(remat=remat), opt,
                          InputShape("cli", seq, batch, "train"),
                          num_microbatches=micro)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    return dict(device=dev, mesh=mesh, bound=bound, params=params,
                opt_state=opt.init(params), rng=np.random.RandomState(seed))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_arch(cfg, *, steps: int = 20, ckpt=None, ckpt_every: int = 50,
             label: str = "smoke", **setup) -> dict:
    """Train ``cfg`` for ``steps`` steps (``setup`` goes to ``setup_arch``)
    and print the reference's lines, each step's with its kernel launches.
    Returns dict(params, opt_state, losses, step_s (each step's seconds on
    the host clock, ending in a synchronize), launches (per step: flash,
    flash writing lse, flash backward, rmsnorm, rmsnorm backward),
    n_params, n_micro, store)."""
    run = setup_arch(cfg, **setup)
    dev, bound = run["device"], run["bound"]
    # popped: each step's inputs are freed once its outputs exist
    params, opt_state = run.pop("params"), run.pop("opt_state")
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"[arch] {cfg.name} ({label}) params={n_params:,} "
          f"micro={bound['n_micro']} device={dev} "
          f"mesh={tuple(run['mesh'].shape)}")
    store = CheckpointStore(ckpt) if ckpt else None
    losses, step_s, launches = [], [], []
    t0 = time.time()
    for step in range(steps):
        batch = sample_batch(run["rng"], bound["batch_shape"], cfg.vocab, dev)
        before = (FA.flash_attention.launches,
                  FA.flash_attention.lse_launches, RN.rmsnorm.launches,
                  FA.flash_attention_bwd.launches, RN.rmsnorm_bwd.launches)
        _sync(dev)
        ts = time.perf_counter()
        params, opt_state, mets = bound["step"](params, opt_state, batch)
        losses.append(float(mets["loss"]))
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
        launches.append({"flash_attention": FA.flash_attention.launches -
                         before[0],
                         "flash_lse": FA.flash_attention.lse_launches -
                         before[1],
                         "flash_bwd": FA.flash_attention_bwd.launches -
                         before[3],
                         "rmsnorm": RN.rmsnorm.launches - before[2],
                         "rmsnorm_bwd": RN.rmsnorm_bwd.launches - before[4]})
        if step % max(steps // 10, 1) == 0 or step == steps - 1:
            print(f"  step {step:4d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step; this step "
                  f"{step_s[-1]:.3f}s, kernel launches {launches[-1]})")
        if store and (step + 1) % ckpt_every == 0:
            state = SP.writer_copy(run["mesh"],
                                   {"params": params, "opt": opt_state})
            if state is not None:
                v = (store.latest() or 0) + 1
                store.save(v, state, meta={"step": step + 1})
                print(f"  checkpoint v{v}")
            del state
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{cfg.name}: non-finite loss {losses}")
    print(f"[arch] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"in {time.time() - t0:.1f}s")
    return dict(params=params, opt_state=opt_state, losses=losses,
                step_s=step_s, launches=launches, n_params=n_params,
                n_micro=bound["n_micro"], store=store)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--arch", default=None, choices=C.ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="the full published config (on the card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["rmsprop", "sgd", "adamw"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--versions", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--codec", default="none",
                    choices=["none", "topk", "ternary"])
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "wire"])
    args = ap.parse_args(argv)
    if args.paper:
        run_paper(workers=args.workers, versions=args.versions,
                  seed=args.seed, device=args.device, codec=args.codec,
                  transport=args.transport)
        return 0
    if not args.arch:
        raise SystemExit("need --paper or --arch <id>")
    run_arch(arch_config(args.arch, args.full), steps=args.steps,
             ckpt=args.ckpt, ckpt_every=args.ckpt_every,
             label="full" if args.full else "smoke", batch=args.batch,
             seq=args.seq, micro=args.micro, lr=args.lr,
             optimizer=args.optimizer, seed=args.seed,
             remat=not args.no_remat, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
