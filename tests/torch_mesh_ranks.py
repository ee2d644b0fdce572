"""The ranks of the gloo meshes that ``tests/test_torch_distributed.py``
and ``tests/test_torch_tensor_parallel.py`` run, and the cases both sides
share.

Run as a script, one process a rank: ``python tests/torch_mesh_ranks.py
<job.json> <rank>``. A rank imports only torch, numpy and ``repro_torch``
(the JAX side of each comparison runs in the test process). It joins a
gloo process group through a file store (no TCP port to race for), with a
timeout on every collective, builds the job's ``DeviceMesh`` over
``("data", "model")``, runs every case of the job (``"kind"``: the
distributed file's, or ``"tp"``, the tensor-parallel file's) on the
inputs the test wrote (``in_<case>.npz``) and writes what it holds to
``<case>_r<rank>.npz``.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import pathlib
import sys
import weakref

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] /
                           "src"))

import repro_torch.configs as C  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.distributed import spmd as SP  # noqa: E402
from repro_torch.distributed import steps as ST  # noqa: E402
from repro_torch.distributed.sharding import ShardingPolicy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.runtime import DEFAULT, Runtime  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402

ARCHS = ["stablelm-1.6b", "deepseek-moe-16b", "falcon-mamba-7b",
         "whisper-base"]
MESHES = [(2, 2), (4, 1)]
BATCH, SEQ, MICRO = 8, 16, 2
LR = {"sgd": 0.1, "adamw": 1e-3}
# serving: the batch divides both meshes' data axes, the cache (PROMPT +
# DECODE + 8 positions) the model axis
SERVE_BATCH, PROMPT, DECODE = 4, 8, 3
MAX_SEQ = PROMPT + DECODE + 8
# deepseek's smoke router at this capacity drops assignments in every
# microbatch (C = 16 slots an expert for 128 assignments over 4 experts)
MOE_CAPACITY = 0.5
BF16_ARCH = "stablelm-1.6b"


# the tensor-parallel cases: five smoke configs and one whose vocab 4 does
# not divide (its embed and unembed fall back to d_model and compute
# replicated); each trains with and without seq_parallel
TP_MESHES = [(2, 2), (1, 4)]
TP_CASES = ["stablelm-1.6b", "deepseek-moe-16b", "falcon-mamba-7b",
            "whisper-base", "qwen1.5-110b", "internvl2-1b@511"]


def config(arch):
    """The smoke config both sides run (deepseek at ``MOE_CAPACITY``; an
    ``arch@V`` case at vocab V)."""
    arch, _, vocab = arch.partition("@")
    cfg = C.get_smoke(arch)
    if vocab:
        cfg = cfg.replace(vocab=int(vocab))
    if cfg.moe.num_experts:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CAPACITY))
    return cfg


def train_shape():
    return InputShape("t", SEQ, BATCH, "train")


def params_of(cfg, leaves):
    """The port's tree of ``cfg`` over numpy leaves in its leaf order."""
    return tree.unflatten(M.init_params(cfg, None, "meta"),
                          [torch.from_numpy(np.array(a)) for a in leaves])


class DropLog:
    """Records the dropped assignments of every sort dispatch
    (``moe.dispatch``), in call order."""

    def __init__(self):
        self.drops = []

    def __enter__(self):
        self._orig = MOE.dispatch

        def recording(idx, C_):
            out = self._orig(idx, C_)
            self.drops.append(int((~out[3]).sum()))
            return out

        MOE.dispatch = recording
        return self

    def __exit__(self, *exc):
        MOE.dispatch = self._orig


class FullLeaves:
    """Counts the whole leaves that ``DTensor.full_tensor`` gathers and
    the most of them alive at once (``most``)."""

    def __init__(self):
        self.refs, self.most, self.calls = [], 0, 0

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        self._orig = DTensor.full_tensor

        def counting(t, *args, **kwargs):
            out = self._orig(t, *args, **kwargs)
            self.refs = [r for r in self.refs if r() is not None]
            self.refs.append(weakref.ref(out))
            self.most = max(self.most, len(self.refs))
            self.calls += 1
            return out

        DTensor.full_tensor = counting
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        DTensor.full_tensor = self._orig


class Widths:
    """Records the widths that the model's modules compute with, by
    module: attention's query heads (the flash kernel's or the plain
    attention's q), an mlp's and shared experts' FFN columns, the experts a
    moe layer runs, an ssm's d_inner channels, and the embedding's and the
    logits' vocab; ``seen[what]`` is the set of widths."""

    def __init__(self):
        self.seen = {}

    def _wrap(self, mod, name, what, width=None):
        """Record ``width(*args)`` of each call of ``mod.name`` (None: its
        output's last dim) under ``what``."""
        orig = getattr(mod, name)

        def recording(*args, **kwargs):
            out = orig(*args, **kwargs)
            w = out.shape[-1] if width is None else width(*args)
            self.seen.setdefault(what, set()).add(int(w))
            return out

        setattr(mod, name, recording)
        self._undo.append((mod, name, orig))

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import layers as L
        from repro_torch.models import ssm as SSM
        self._undo = []
        self._wrap(ops, "attention", "attention", lambda q, *a: q.shape[2])
        self._wrap(L, "plain_attention", "attention",
                   lambda q, *a: q.shape[2])
        self._wrap(L, "apply_mlp", "mlp", lambda p, *a: p["wi"].shape[-1])
        self._wrap(MOE, "_expert_ffn", "experts", lambda ep, h, *a:
                   h.shape[0])
        self._wrap(MOE, "_shared_ffn", "shared", lambda sp, *a:
                   sp["wi"].shape[-1])
        self._wrap(SSM, "_causal_conv", "ssm", lambda x, w, *a: w.shape[-1])
        self._wrap(M, "_embed", "embed", lambda cfg, p, *a:
                   p["embed"].shape[0])
        self._wrap(M, "_logits", "logits")
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)


def train_case(mesh, cfg, params, batch, opt_name, policy=None):
    """One ``bind_train`` step (remat, ``MICRO`` microbatches): (params,
    opt_state, metrics, drops, collective calls, bound), the trees as
    this rank's local tensors."""
    opt = O.make(opt_name, LR[opt_name])
    bound = ST.bind_train(mesh, cfg, Runtime(remat=True), opt, train_shape(),
                          policy=policy, num_microbatches=MICRO)
    state = opt.init(params)
    SP.COLLECTIVES.reset()
    with DropLog() as log:
        p, s, m = bound["step"](params, state, batch)
    calls = dict(SP.COLLECTIVES.calls)
    local = lambda t: tree.map(SP.local_of, t)  # noqa: E731
    return local(p), local(s), m, log.drops, calls, bound


def serve_case(mesh, cfg, params, prompt_batch):
    """Prefill ``prompt_batch`` and decode ``DECODE`` greedy tokens through
    ``bind_prefill`` / ``bind_decode``: (logits a step, tokens a step,
    collective calls of the prefill and of each decode step)."""
    pre = ST.bind_prefill(mesh, cfg, DEFAULT,
                          InputShape("p", PROMPT, SERVE_BATCH, "prefill"))
    dec = ST.bind_decode(mesh, cfg, DEFAULT,
                         InputShape("d", MAX_SEQ, SERVE_BATCH, "decode"))
    p = SP.put(mesh, params, pre["param_specs"])
    cache = SP.put(mesh, M.init_cache(cfg, SERVE_BATCH, MAX_SEQ),
                   dec["cache_specs"])
    logits_all, toks, calls = [], [], []
    SP.COLLECTIVES.reset()
    logits, cache = pre["step"](p, prompt_batch, cache)
    calls.append(dict(SP.COLLECTIVES.calls))
    for t in range(DECODE + 1):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits_all.append(logits)
        toks.append(tok)
        if t == DECODE:
            break
        SP.COLLECTIVES.reset()
        logits, cache = dec["step"](p, cache, tok, PROMPT + t)
        calls.append(dict(SP.COLLECTIVES.calls))
    return torch.stack(logits_all), torch.stack(toks), calls


def _flat(prefix, tr):
    return {f"{prefix}{i}": t.detach().numpy()
            for i, t in enumerate(tree.leaves(tr))}


def _calls(prefix, calls):
    return {f"{prefix}{k}": np.int64(v) for k, v in calls.items()}


def run_rank(job, rank: int) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    out = pathlib.Path(job["dir"])
    shape = tuple(job["mesh"])
    dist.init_process_group(
        "gloo", init_method=f"file://{job['store']}", rank=rank,
        world_size=int(np.prod(shape)),
        timeout=datetime.timedelta(seconds=job["timeout_s"]))
    try:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        if job.get("kind") == "tp":
            run_tp(out, mesh)
            dist.barrier()
            return
        coord = np.array(mesh.get_coordinate())
        for arch in ARCHS:
            cfg = config(arch)
            data = np.load(out / f"in_{arch}.npz")
            leaves = [data[f"p{i}"] for i in range(int(data["n"]))]
            batch = {k[2:]: torch.from_numpy(data[k]) for k in data.files
                     if k.startswith("b_")}
            prompt = {k[2:]: torch.from_numpy(data[k]) for k in data.files
                      if k.startswith("q_")}
            for opt_name in ("sgd", "adamw"):
                placed = SP.put(mesh, params_of(cfg, leaves),
                                ST.bind_train(mesh, cfg, Runtime(),
                                              O.make(opt_name, 0.1),
                                              train_shape())["param_specs"])
                init = tree.map(SP.local_of, placed)
                p, s, m, drops, calls, _ = train_case(
                    mesh, cfg, params_of(cfg, leaves), batch, opt_name)
                res = {**_flat("p", p), **_flat("i", init),
                       **{f"m_{k}": np.float32(v) for k, v in m.items()},
                       "drops": np.array(drops, np.int64), "coord": coord,
                       **_calls("c_", calls)}
                for slot in ("m", "v"):
                    if slot in s:
                        res.update(_flat(f"s{slot}_", s[slot]))
                np.savez(out / f"train_{arch}_{opt_name}_r{rank}.npz", **res)
            logits, toks, calls = serve_case(mesh, cfg,
                                             params_of(cfg, leaves), prompt)
            res = {"logits": logits.numpy(), "tokens": toks.numpy()}
            for i, c in enumerate(calls):
                res.update(_calls(f"c{i}_", c))
            np.savez(out / f"serve_{arch}_r{rank}.npz", **res)
        # the gradients of one step accumulated in bf16
        cfg = config(BF16_ARCH)
        data = np.load(out / f"in_{BF16_ARCH}.npz")
        leaves = [data[f"p{i}"] for i in range(int(data["n"]))]
        bound = ST.bind_train(
            mesh, cfg, Runtime(remat=True), O.sgd(LR["sgd"]), train_shape(),
            policy=ShardingPolicy.for_mesh(mesh, grad_accum_dtype="bfloat16"),
            num_microbatches=MICRO)
        g, _ = bound["grads"](params_of(cfg, leaves),
                              {"tokens": torch.from_numpy(data["b_tokens"])})
        np.savez(out / f"bf16_r{rank}.npz",
                 **_flat("g", tree.map(SP.local_of, g)))
        if shape[1] == 1:
            _drivers(out, rank, shape)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _drivers(out, rank, shape):
    """The drivers under the process group: ``make_host_mesh`` gives the
    (N, 1) ``DeviceMesh``, and ``serve`` and ``run_arch`` (with a
    checkpoint) run on it."""
    from repro_torch.launch import serve as S
    from repro_torch.launch import train as TR
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh("cpu")
    assert tuple(mesh.shape) == shape and \
        tuple(mesh.mesh_dim_names) == ("data", "model")
    cfg = config(BF16_ARCH)
    served = S.serve(cfg, **DRIVER_SERVE, device="cpu")
    # rank 0 writes the checkpoint of the step's state, gathered a leaf
    # at a time
    with FullLeaves() as full:
        trained = TR.run_arch(cfg, **DRIVER_TRAIN, ckpt=str(out / "ckpt"),
                              ckpt_every=DRIVER_TRAIN["steps"], device="cpu")
    np.savez(out / f"drivers_r{rank}.npz", tokens=served["tokens"].numpy(),
             losses=np.array(trained["losses"], np.float64),
             full_most=np.int64(full.most), full_calls=np.int64(full.calls))


def _load(out, case):
    data = np.load(out / f"in_{case}.npz")
    leaves = [data[f"p{i}"] for i in range(int(data["n"]))]
    batch = {k[2:]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("b_")}
    prompt = {k[2:]: torch.from_numpy(data[k]) for k in data.files
              if k.startswith("q_")}
    return leaves, batch, prompt


def run_tp(out, mesh) -> None:
    """The tensor-parallel cases: each of ``TP_CASES`` trains one step
    with SGD and with AdamW, with and without ``seq_parallel``, and serves
    (prefill and decode), recording its shards, metrics, drops,
    collectives and the widths its modules computed with; then one
    ``seq_parallel`` binding at a sequence ``model`` does not divide,
    which must raise before any collective."""
    rank = torch.distributed.get_rank()
    for case in TP_CASES:
        cfg = config(case)
        leaves, batch, prompt = _load(out, case)
        for sp in (False, True):
            for opt_name in ("sgd", "adamw"):
                policy = ShardingPolicy.for_mesh(mesh, seq_parallel=sp)
                with Widths() as widths:
                    p, s, m, drops, calls, _ = train_case(
                        mesh, cfg, params_of(cfg, leaves), batch, opt_name,
                        policy)
                res = {**_flat("p", p),
                       **{f"m_{k}": np.float32(v) for k, v in m.items()},
                       "drops": np.array(drops, np.int64),
                       **_calls("c_", calls), **_widths(widths)}
                for slot in ("m", "v"):
                    if slot in s:
                        res.update(_flat(f"s{slot}_", s[slot]))
                tag = "sp" if sp else "tp"
                np.savez(out / f"{tag}_{case}_{opt_name}_r{rank}.npz", **res)
        with Widths() as widths:
            logits, toks, calls = serve_case(mesh, cfg, params_of(cfg, leaves),
                                             prompt)
        res = {"logits": logits.numpy(), "tokens": toks.numpy(),
               **_widths(widths)}
        for i, c in enumerate(calls):
            res.update(_calls(f"c{i}_", c))
        np.savez(out / f"serve_{case}_r{rank}.npz", **res)
    cfg = config(TP_CASES[0])
    SP.COLLECTIVES.reset()
    try:
        ST.bind_train(mesh, cfg, Runtime(), O.sgd(LR["sgd"]),
                      InputShape("t", 4 * mesh.shape[1] + 1, BATCH, "train"),
                      policy=ShardingPolicy.for_mesh(mesh, seq_parallel=True))
        raised = ""
    except ValueError as e:
        raised = str(e)
    np.savez(out / f"refusal_r{rank}.npz", raised=np.array(raised),
             calls=np.int64(sum(SP.COLLECTIVES.calls.values())))


def _widths(w):
    return {f"w_{k}": np.array(sorted(v), np.int64) for k, v in w.seen.items()}


# the drivers' runs (both sides)
DRIVER_SERVE = dict(requests=4, batch=4, prompt=8, tokens=3, seed=0)
DRIVER_TRAIN = dict(steps=2, batch=8, seq=8, micro=2, optimizer="sgd",
                    lr=0.1, seed=0)


if __name__ == "__main__":
    run_rank(json.loads(pathlib.Path(sys.argv[1]).read_text()),
             int(sys.argv[2]))
