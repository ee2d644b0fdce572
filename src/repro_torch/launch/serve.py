"""Serving driver of the port: batched prefill + greedy decode.

Serves an architecture (reduced by default, the published config with
``--full``) as the JAX package's ``repro.launch.serve`` does: a queue of
requests is packed into fixed batches (the last one padded), each batch is
prefilled into a fresh KV/SSM cache, then decoded token by token. On the
card every RMSNorm runs in the hand-written ``rmsnorm`` kernel and every
prefill attention in the hand-written ``flash_attention`` kernel (the
whisper encoder's non-causal self-attention too; cross-attention and
decode attention stay plain). Every family runs: moe layers through the
sort dispatch at the config's capacity factor, the reference's runtime;
ssm layers through the chunked selective scan, plain torch; an encdec
model's batches carry zero ``frames`` (the stubbed audio front end's
output) and a vlm model's zero ``patches`` (the stubbed ViT's), which a vlm
decode counts ahead of the prompt. As in the JAX package the steps are
bound to the host mesh (``launch/mesh.py::make_host_mesh``) through
``distributed/steps.py``'s ``bind_prefill`` and ``bind_decode``: one card,
or under an initialised process group of N ranks a ``DeviceMesh`` (N, 1),
whose steps shard the weights and the cache and split each batch's rows
over the ranks (``distributed/spmd.py``). Without ``--device cpu`` and
without a card it raises: a run never drops to the CPU on its own.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --device cpu --requests 8 --batch 4 --prompt 32 --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-110b \\
      --device cpu --requests 2 --batch 2 --prompt 8 --tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --device cpu --requests 2 --batch 2 --prompt 8 --tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --device cpu --requests 2 --batch 2 --prompt 8 --tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b --full
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import device as D
from repro_torch.configs.base import InputShape
from repro_torch.distributed import spmd as SP
from repro_torch.distributed import steps as ST
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.runtime import DEFAULT


def greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_prompts(cfg, requests: int, prompt: int, seed: int
                 ) -> List[np.ndarray]:
    """The request queue: ``requests`` prompts of ``prompt`` random tokens,
    drawn from ``np.random.RandomState(seed)`` as ``repro.launch.serve`` draws
    them."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab, size=prompt).astype(np.int32)
            for _ in range(requests)]


def prefix_len(cfg) -> int:
    """The positions a prefill holds ahead of the prompt: the vlm family's
    patches."""
    return cfg.vision_prefix if cfg.family == "vlm" else 0


def extra_inputs(cfg, batch: int, device) -> dict:
    """A batch's entries beside its tokens, as ``repro.launch.serve``
    builds them: zero ``frames`` ``[batch, encoder_seq, d_model]``
    (encdec) or ``patches`` ``[batch, vision_prefix, d_model]`` (vlm) in
    ``cfg.dtype``."""
    dt = M.dtype_of(cfg)
    if cfg.family == "encdec":
        return {"frames": torch.zeros(batch, cfg.encoder_seq, cfg.d_model,
                                      dtype=dt, device=device)}
    if cfg.family == "vlm":
        return {"patches": torch.zeros(batch, cfg.vision_prefix, cfg.d_model,
                                       dtype=dt, device=device)}
    return {}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, *, requests: int, batch: int, prompt: int, tokens: int,
          seed: int, device=None) -> dict:
    """Serve ``requests`` prompts in batches of ``batch``: prefill, then
    ``tokens - 1`` greedy decode steps (each batch with
    ``extra_inputs``, the decode from position ``prefix_len + prompt``;
    the cache holds the prefix too), through ``bind_prefill`` and
    ``bind_decode`` on the host mesh. Weights come from a
    ``torch.Generator`` on the device seeded with ``seed`` (every rank of
    a mesh draws the whole tree and keeps its shards). Returns
    ``{"tokens": int32 [requests, tokens] on the host, "launches":
    {"rmsnorm": n, "flash_attention": n, "rmsnorm_bwd": 0}, "prefill_s":
    [...], "decode_s":
    [...]}``, the seconds of each batch's prefill and of its decode steps
    on the host clock (each ends in a synchronize; the first batch's
    include the first allocations)."""
    if min(requests, batch, prompt, tokens) < 1:
        raise ValueError("requests, batch, prompt and tokens must be >= 1")
    dev = D.resolve(device)
    mesh = make_host_mesh(dev)
    start = prefix_len(cfg) + prompt
    max_seq = start + tokens + 8
    pre = ST.bind_prefill(mesh, cfg, DEFAULT,
                          InputShape("prefill", start, batch, "prefill"))
    dec = ST.bind_decode(mesh, cfg, DEFAULT,
                         InputShape("serve", max_seq, batch, "decode"))
    params = SP.put(mesh, M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev),
        pre["param_specs"])
    prompts = make_prompts(cfg, requests, prompt, seed)
    launches0 = (RN.rmsnorm.launches, FA.flash_attention.launches,
                 RN.rmsnorm_bwd.launches)
    out: List[torch.Tensor] = []
    prefill_s: List[float] = []
    decode_s: List[float] = []
    for done in range(0, requests, batch):
        batch_p = prompts[done:done + batch]
        batch_p += [np.zeros(prompt, np.int32)] * (batch - len(batch_p))
        toks = torch.from_numpy(np.stack(batch_p)).to(dev)
        cache = SP.put(mesh, M.init_cache(cfg, batch, max_seq, device=dev),
                       dec["cache_specs"])
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = pre["step"](params, {"tokens": toks,
                                             **extra_inputs(cfg, batch, dev)},
                                    cache)
        tok = greedy(logits)
        _sync(dev)
        t1 = time.perf_counter()
        outs = [tok]
        for t in range(tokens - 1):
            logits, cache = dec["step"](params, cache, tok, start + t)
            tok = greedy(logits)
            outs.append(tok)
        gen = torch.stack(outs, dim=1).cpu()
        t2 = time.perf_counter()
        prefill_s.append(t1 - t0)
        decode_s.append(t2 - t1)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"{cfg.name}: non-finite logits")
        out.append(gen[:min(batch, requests - done)])
        print(f"  served {min(done + batch, requests)}/{requests}  sample: "
              f"{gen[0, :8].tolist()}")
    return {"tokens": torch.cat(out),
            "launches": {"rmsnorm": RN.rmsnorm.launches - launches0[0],
                         "flash_attention":
                             FA.flash_attention.launches - launches0[1],
                         "rmsnorm_bwd":
                             RN.rmsnorm_bwd.launches - launches0[2]},
            "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="stablelm-1.6b", choices=C.ARCH_IDS)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = C.get(args.arch) if args.full else C.get_smoke(args.arch)
    t0 = time.perf_counter()
    res = serve(cfg, requests=args.requests, batch=args.batch,
                prompt=args.prompt, tokens=args.tokens, seed=args.seed,
                device=args.device)
    dt = time.perf_counter() - t0
    n_new = args.requests * args.tokens
    print(f"[serve] {cfg.name}: {n_new} tokens in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s); prefill {sum(res['prefill_s']):.3f}s, "
          f"decode {sum(res['decode_s']):.3f}s; kernel launches "
          f"{res['launches']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
