"""The port's vlm family (internvl2-1b's smoke config: 8 stubbed patch
embeddings ahead of the tokens, RMSNorm, SwiGLU, GQA with QKV bias, RoPE;
and the same at internvl2-1b's group of 7 query heads a kv head, 14 over
2) against the JAX package, on the CPU: ``forward`` (the logits of the
tokens only), the training loss and every gradient leaf against
``jax.grad``, prefill + greedy decode from position ``P + St`` with every
cache leaf, decode against the port's own forward, a bf16 forward, the
published config's parameter count and specs, the training batches' draws
and the entry points on the CPU. The helpers and tolerances are
``tests/test_torch_encdec.py``'s.
"""
from __future__ import annotations

import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.models import model as TM
from repro_torch.models.runtime import DEFAULT
from test_torch_encdec import (check_bf16_forward,
                               check_decode_matches_forward, check_forward,
                               check_grads, check_loss,
                               check_prefill_and_decode, check_published,
                               check_sample_batch, check_serve_on_the_cpu,
                               check_train_main, jax_params, loss_and_grads,
                               make_batch)

ARCH = "internvl2-1b"
PUBLISHED_PARAMS = 629_663_872
# internvl2-1b's 14 query heads over 2 kv heads (G = 7) at smoke widths
G7 = dict(n_heads=14, n_kv_heads=2, head_dim=16)
CASES = ["smoke", "g7"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for case in CASES:
        jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
        if case == "g7":
            jcfg, tcfg = jcfg.replace(**G7), tcfg.replace(**G7)
            assert tcfg.n_heads // tcfg.n_kv_heads == 7
        out[case] = (jcfg, tcfg, jax_params(jcfg))
    return out


@pytest.fixture(scope="module")
def grads(models):
    return {case: loss_and_grads(*m) for case, m in models.items()}


def test_smoke_config_has_a_prefix_and_groups():
    cfg = TC.get_smoke(ARCH)
    assert (cfg.family, cfg.vision_prefix, cfg.n_heads, cfg.n_kv_heads) == \
        ("vlm", 8, 4, 2)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(models, case):
    check_forward(*models[case])


def test_forward_drops_the_prefix(models):
    """The logits are the tokens' only, and a patch reaches them through
    attention: changing the patches changes every token's logits."""
    _, tcfg, p = models["smoke"]
    tp = bridge.params_from_jax(p, "cpu")
    b = {k: torch.from_numpy(v) for k, v in make_batch(tcfg, 2, 5, 3).items()}
    logits, _ = TM.forward(tp, tcfg, DEFAULT, b)
    assert logits.shape == (2, 5, tcfg.padded_vocab)
    other, _ = TM.forward(tp, tcfg, DEFAULT, dict(b, patches=b["patches"] + 1))
    assert bool((other - logits).abs().amax(-1).gt(1e-4).all())


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_match_jax(models, case):
    assert check_prefill_and_decode(*models[case]) == ["l0.k", "l0.v"]


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_forward(models, case):
    check_decode_matches_forward(models[case][1], models[case][2])


@pytest.mark.parametrize("case", CASES)
def test_loss_matches_jax(grads, case):
    check_loss(grads[case])


@pytest.mark.parametrize("case", CASES)
def test_every_gradient_leaf_matches_jax(grads, case):
    assert "blocks.l0.attn.bk" in check_grads(grads[case], rope=True)


def test_bf16_forward_matches_jax(models):
    check_bf16_forward(*models["smoke"][:2])


def test_published_config_counts_and_specs():
    check_published(ARCH, PUBLISHED_PARAMS)
    spec = TM.train_batch_spec(TC.get(ARCH), TC.InputShape("t", 4096, 8,
                                                           "train"))
    # 256 patches + 3,840 tokens make the 4,096 positions
    assert spec["patches"].shape == (8, 256, 896)
    assert spec["tokens"].shape == (8, 4096 - 256 + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_batch_draws_like_jax(dtype):
    check_sample_batch(ARCH, dtype)


def test_serve_on_the_cpu():
    check_serve_on_the_cpu(ARCH)


def test_train_main_on_the_cpu(tmp_path, capsys):
    assert check_train_main(ARCH, tmp_path, capsys) == [
        "blocks", "embed", "final_norm", "unembed"]


def test_serve_decodes_after_the_prefix(monkeypatch):
    """``serve()`` decodes from position P + prompt, into a cache that
    holds the prefix: the positions it passes to ``decode_step``."""
    cfg = TC.get_smoke(ARCH)
    real, seen = TM.decode_step, []

    def spy(params, cfg_, rt, token, cache, pos):
        seen.append((pos, cache["l0"]["k"].shape[2]))
        return real(params, cfg_, rt, token, cache, pos)

    monkeypatch.setattr(TM, "decode_step", spy)
    from repro_torch.launch import serve as S
    S.serve(cfg, requests=1, batch=1, prompt=6, tokens=3, seed=0,
            device="cpu")
    P = cfg.vision_prefix
    assert seen == [(P + 6, P + 6 + 3 + 8), (P + 7, P + 6 + 3 + 8)]
