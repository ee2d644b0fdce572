"""Serving driver of the port: batched prefill + greedy decode.

Serves an architecture (reduced by default, the published config with
``--full``) as the JAX package's ``repro.launch.serve`` does: a queue of
requests is packed into fixed batches (the last one padded), each batch is
prefilled into a fresh KV cache, then decoded token by token. On the card
every RMSNorm runs in the hand-written ``rmsnorm`` kernel and every prefill
attention in the hand-written ``flash_attention`` kernel. The dense family
runs; other families raise. Without ``--device cpu`` and without a card it
raises: a run never drops to the CPU on its own.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-110b \\
      --device cpu --requests 2 --batch 2 --prompt 8 --tokens 4
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import device as D
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models import model as M


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


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, *, requests: int, batch: int, prompt: int, tokens: int,
          seed: int, device=None) -> dict:
    """Serve ``requests`` prompts in batches of ``batch``: prefill, then
    ``tokens - 1`` greedy decode steps. Weights come from a
    ``torch.Generator`` on the device seeded with ``seed``. Returns
    ``{"tokens": int32 [requests, tokens] on the host, "launches":
    {"rmsnorm": n, "flash_attention": n}, "prefill_s": [...], "decode_s":
    [...]}``, the seconds of each batch's prefill and of its decode steps
    on the host clock (each ends in a synchronize; the first batch's
    include the first allocations)."""
    if min(requests, batch, prompt, tokens) < 1:
        raise ValueError("requests, batch, prompt and tokens must be >= 1")
    dev = D.resolve(device)
    max_seq = prompt + tokens + 8
    params = M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prompts = make_prompts(cfg, requests, prompt, seed)
    launches0 = (RN.rmsnorm.launches, FA.flash_attention.launches)
    out: List[torch.Tensor] = []
    prefill_s: List[float] = []
    decode_s: List[float] = []
    for done in range(0, requests, batch):
        batch_p = prompts[done:done + batch]
        batch_p += [np.zeros(prompt, np.int32)] * (batch - len(batch_p))
        toks = torch.from_numpy(np.stack(batch_p)).to(dev)
        cache = M.init_cache(cfg, batch, max_seq, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, cfg, {"tokens": toks}, cache)
        tok = greedy(logits)
        _sync(dev)
        t1 = time.perf_counter()
        outs = [tok]
        for t in range(tokens - 1):
            logits, cache = M.decode_step(params, cfg, tok, cache,
                                          prompt + t)
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
                             FA.flash_attention.launches - launches0[1]},
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
