"""The port's dense transformer serving path against the JAX package, on
the CPU.

JAX's ``init_params`` of a smoke config crosses into the port through
``bridge.params_from_jax`` (with the zero biases and unit norm scales made
random, in numpy, on both sides, so the biases and scales count); the same
prompt then goes through ``repro.models.model.prefill`` + ``decode_step``
and the port's, greedy, for three decode steps. JAX runs at ``highest``
matmul precision (``tests/conftest.py``). The JAX prefill runs its chunked
jnp flash attention and the port the flash kernel's plain version, so the
logits agree within a tolerance, not bit for bit:

- fp32: 1e-5 absolute on logits of size ~0.6 (measured differences ~3e-7,
  summation order only);
- bf16: 2e-2 (``tests/test_kernels.py::_tol``; the two packages round the
  bf16 activations at different places, measured differences ~3e-3).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import model as JM
from repro.models.runtime import Runtime as JRuntime
from repro_torch import bridge, tree
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import serve as S
from repro_torch.models import model as TM
from repro_torch.models.runtime import DEFAULT

LOGIT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PROMPT, BATCH, STEPS = 9, 2, 3

CASES = {
    "qwen-fp32": ("qwen1.5-110b", "float32", {}),
    "qwen-bf16": ("qwen1.5-110b", "bfloat16", {}),
    "stablelm": ("stablelm-1.6b", "float32", {}),    # LayerNorm, 25% RoPE, MHA
    "qwen-window": ("qwen1.5-110b", "float32", {"sliding_window": 5}),
    "minitron": ("minitron-4b", "float32", {}),      # squared ReLU, 50% RoPE
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Smoke shapes: one intra-op thread is as fast, and it leaves the other
    cores to the timing-sensitive tests running beside these."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype, over):
    return (JC.get_smoke(arch).replace(dtype=dtype, **over),
            TC.get_smoke(arch).replace(dtype=dtype, **over))


def _jax_params(jcfg, seed=0):
    """JAX's params as numpy, with biases and norm scales drawn at random
    (JAX initialises them to 0 and 1), in the params' dtype."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(
        seed)))

    def perturb(path, a):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "bias"):
            return (rng.randn(*a.shape) * 0.02).astype(a.dtype)
        if name == "scale":
            return (1 + rng.randn(*a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, params)


def _greedy_runs(case):
    """Prefill + STEPS greedy decode steps in both packages from the same
    weights and prompt: (logits per step, tokens per step) of each."""
    arch, dtype, over = CASES[case]
    jcfg, tcfg = _configs(arch, dtype, over)
    np_params = _jax_params(jcfg)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = bridge.params_from_jax(np_params, "cpu")
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab, size=(BATCH, PROMPT)).astype(np.int32)
    max_seq = PROMPT + STEPS + 8
    jrt = JRuntime(remat=False)

    jpre = jax.jit(JM.prefill, static_argnums=(1, 2))
    jdec = jax.jit(JM.decode_step, static_argnums=(1, 2))
    jl, jc = jpre(jp, jcfg, jrt, {"tokens": jnp.asarray(toks)},
                  JM.init_cache(jcfg, BATCH, max_seq))
    tl, tc = TM.prefill(tp, tcfg, DEFAULT, {"tokens": torch.from_numpy(toks)},
                        TM.init_cache(tcfg, BATCH, max_seq))
    j_out, t_out = [(jl, jnp.argmax(jl, -1))], [(tl, S.greedy(tl))]
    for s in range(STEPS):
        jl, jc = jdec(jp, jcfg, jrt, j_out[-1][1].astype(jnp.int32), jc,
                      jnp.int32(PROMPT + s))
        tl, tc = TM.decode_step(tp, tcfg, DEFAULT, t_out[-1][1], tc,
                                PROMPT + s)
        j_out.append((jl, jnp.argmax(jl, -1)))
        t_out.append((tl, S.greedy(tl)))
    return dtype, j_out, t_out, (tp, tcfg, toks)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    dtype, j_out, t_out, (tp, tcfg, toks) = _greedy_runs(case)
    tol = LOGIT_TOL[dtype]
    for step, ((jl, jt), (tl, tt)) in enumerate(zip(j_out, t_out)):
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol, err_msg=f"step {step}")
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"greedy tokens, step {step}")
    # forward's last row is prefill's logits (same kernels, no cache)
    logits, aux = TM.forward(tp, tcfg, DEFAULT,
                             {"tokens": torch.from_numpy(toks)})
    assert logits.shape == (BATCH, PROMPT, tcfg.vocab) and float(aux) == 0
    torch.testing.assert_close(logits[:, -1], t_out[0][0], rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "stablelm-1.6b"])
def test_forward_matches_jax_at_every_position(arch):
    """``forward`` (no cache: the flash kernel's plain version) against
    ``repro.models.model.forward`` at every position of the sequence, not
    only the last."""
    jcfg, tcfg = _configs(arch, "float32", {})
    np_params = _jax_params(jcfg)
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    jl, _ = JM.forward(jax.tree.map(jnp.asarray, np_params), jcfg,
                       JRuntime(remat=False), {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(bridge.params_from_jax(np_params, "cpu"), tcfg,
                       DEFAULT, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=LOGIT_TOL["float32"],
                               atol=LOGIT_TOL["float32"])


# ---------------------------------------------------------------------------
# the bridge carries bf16 and a whole transformer tree
# ---------------------------------------------------------------------------

def test_bf16_leaf_crosses_bit_for_bit():
    a = np.array(jnp.asarray(np.random.RandomState(0).randn(5, 7)
                             .astype(np.float32)).astype(jnp.bfloat16))
    a[0, :3] = np.array([np.inf, -0.0, np.nan], np.float32).astype(a.dtype)
    t = bridge.params_from_jax({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16 and t.shape == (5, 7)
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    back = bridge.to_numpy({"w": t})["w"]
    assert back.dtype == a.dtype and np.array_equal(
        back.view(np.int16), a.view(np.int16))


def test_transformer_tree_crosses_and_init_layout_matches_jax():
    jcfg, tcfg = _configs("qwen1.5-110b", "bfloat16", {"n_layers": 3})
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(np_params, "cpu")
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(np_params)[0]]
    mine = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for t_tree in (tp, mine):
        assert tree.map(lambda x: (tuple(x.shape), x.dtype), t_tree) == \
            tree.map(lambda x: (tuple(x.shape), torch.bfloat16), tp)
    assert len(jpaths) == len(tree.leaves(tp)) == 15
    assert tp["blocks"]["l0"]["attn"]["wq"].shape == (3, 128, 4, 32)
    for a, t in zip(jax.tree.leaves(np_params), tree.leaves(tp),
                    strict=True):
        assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    # the port's own draws: 0.02 * truncated normal on [-2, 2], cast to
    # bf16 (which may round 0.04 up to 0.04004)
    wq = mine["blocks"]["l0"]["attn"]["wq"].float()
    assert 0 < wq.abs().max().item() <= 0.0401 and wq.std().item() > 0.01
    again = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(mine),
                                                 tree.leaves(again)))


# ---------------------------------------------------------------------------
# configs and families
# ---------------------------------------------------------------------------

def test_config_registry_matches_jax():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    for name in TC.ARCH_IDS + ["paper-lstm"]:
        for get in ("get", "get_smoke"):
            t, j = getattr(TC, get)(name), getattr(JC, get)(name)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), (name, get)
            assert (t.hd, t.padded_vocab) == (j.hd, j.padded_vocab)
            assert [t.layer_kind(i) for i in range(8)] == \
                [j.layer_kind(i) for i in range(8)]
            assert [t.layer_is_moe(i) for i in range(8)] == \
                [j.layer_is_moe(i) for i in range(8)]
    assert TC.get_shape("decode_32k") == TC.InputShape("decode_32k", 32_768,
                                                       128, "decode")


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-1b"])
def test_unported_families_raise(arch):
    cfg = TC.get_smoke(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match=cfg.family):
        TM.init_cache(cfg, 1, 4)


# ---------------------------------------------------------------------------
# serve() and its CLI
# ---------------------------------------------------------------------------

def test_serve_on_the_cpu():
    cfg = TC.get_smoke("qwen1.5-110b")
    before = (RN.rmsnorm.launches, FA.flash_attention.launches)
    res = S.serve(cfg, requests=3, batch=2, prompt=6, tokens=4, seed=0,
                  device="cpu")
    assert res["tokens"].shape == (3, 4) and res["tokens"].dtype == \
        torch.int32
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()
    # on the CPU the plain versions run: no kernel launch is counted
    assert res["launches"] == {"rmsnorm": 0, "flash_attention": 0,
                               "rmsnorm_bwd": 0}
    assert (RN.rmsnorm.launches, FA.flash_attention.launches) == before
    assert len(res["prefill_s"]) == len(res["decode_s"]) == 2
    assert min(res["prefill_s"] + res["decode_s"]) > 0
    again = S.serve(cfg, requests=3, batch=2, prompt=6, tokens=4, seed=0,
                    device="cpu")
    assert torch.equal(res["tokens"], again["tokens"])
    # the prompts are those of repro.launch.serve: RandomState(seed), one each
    rng = np.random.RandomState(0)
    want = [rng.randint(0, cfg.vocab, size=6).astype(np.int32)
            for _ in range(3)]
    assert all(np.array_equal(a, b) for a, b in
               zip(S.make_prompts(cfg, 3, 6, 0), want, strict=True))


def test_serve_main_runs_on_the_cpu(capsys):
    assert S.main(["--arch", "qwen1.5-110b", "--device", "cpu", "--requests",
                   "2", "--batch", "2", "--prompt", "8", "--tokens", "4"]) == 0
    assert "[serve] qwen1.5-110b: 8 tokens" in capsys.readouterr().out
