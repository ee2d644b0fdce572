"""The port's sharding rules (``distributed/sharding.py``) against the JAX
package's, on the CPU, with no ranks: pure functions of shapes.

For every architecture, on the production meshes (the reference's
``SINGLE`` 16x16 and ``MULTI`` 2x16x16 policies, ``tests/test_sharding.py``)
and with ``attn_hd_fallback`` on and off, the specs equal JAX's path for
path: ``param_specs`` of the meta-device tree against JAX's on
``jax.eval_shape``, ``opt_state_specs`` of adamw, rmsprop and sgd,
``batch_specs`` of a training batch, ``cache_specs`` at a decode_32k-like
shape (batch 128) and a long_500k-like one (batch 1), and
``activation_spec``; ``_microbatch_count`` on the reference's meshes. JAX
writes an entry of one axis as that axis (``("data",)`` reads ``"data"``),
so both sides' entries are compared in that form.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as JC
from repro.configs.base import InputShape as JShape
from repro.distributed import sharding as JSH
from repro.distributed import steps as JST
from repro.models import model as JM
from repro.optim import optimizers as JO
import repro_torch.configs as TC
from repro_torch import tree
from repro_torch.configs.base import InputShape
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import steps as TST
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO

MESHES = {"16x16": ("data", "model"), "2x16x16": ("pod", "data", "model")}
SIZES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}
CACHES = {"decode_32k": (128, 32_768), "long_500k": (1, 524_288)}


def _policies(mesh, **kw):
    return (JSH.ShardingPolicy(MESHES[mesh], SIZES[mesh], **kw),
            SH.ShardingPolicy(MESHES[mesh], SIZES[mesh], **kw))


def _entry(e):
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _norm(spec):
    return tuple(_entry(e) for e in spec)


def _jax_paths(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            _norm(s) for p, s in flat}


def _port_paths(specs, shapes):
    """specs by the key paths of the tree they describe (a spec is a tuple,
    which ``tree.leaf_paths`` would enter)."""
    return {tuple(str(k) for k in p): _norm(s)
            for p, s in zip(tree.leaf_paths(shapes),
                            tree.leaves(specs, is_leaf=SH.is_spec),
                            strict=True)}


@functools.cache
def _shapes(arch):
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    jshape = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    return jcfg, tcfg, jshape, TM.init_params(tcfg, None, "meta")


@pytest.mark.parametrize("fallback", [True, False], ids=["hd", "no_hd"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_specs_match_jax(arch, mesh, fallback):
    _, _, jshape, tshape = _shapes(arch)
    jpol, tpol = _policies(mesh, attn_hd_fallback=fallback)
    want = _jax_paths(JSH.param_specs(jshape, jpol))
    got = _port_paths(SH.param_specs(tshape, tpol), tshape)
    assert got == want
    # the rules did shard (production axes of 16)
    assert any(any(e is not None for e in s) for s in got.values())


@pytest.mark.parametrize("opt", ["adamw", "rmsprop", "sgd"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_opt_state_specs_match_jax(arch, opt):
    jcfg, _, jshape, tshape = _shapes(arch)
    jpol, tpol = _policies("16x16")
    jopt, topt = JO.make(opt, 0.1), TO.make(opt, 0.1)
    jstate = jax.eval_shape(lambda: jopt.init(jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), jshape)))
    want = _jax_paths(JSH.opt_state_specs(jstate,
                                          JSH.param_specs(jshape, jpol)))
    tstate = topt.init(tshape)
    got = _port_paths(SH.opt_state_specs(tstate,
                                         SH.param_specs(tshape, tpol)), tstate)
    assert got == want
    assert got[("step",)] == ()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_batch_specs_match_jax(arch, mesh):
    jcfg, tcfg, _, _ = _shapes(arch)
    jpol, tpol = _policies(mesh)
    for batch in (256, 8, 1):
        want = _jax_paths(JSH.batch_specs(
            JM.train_batch_spec(jcfg, JShape("t", 4096, batch, "train")),
            jpol))
        tbatch = {k: torch.empty(s.shape, device="meta") for k, s in
                  TM.train_batch_spec(tcfg, InputShape("t", 4096, batch,
                                                       "train")).items()}
        got = _port_paths(SH.batch_specs(tbatch, tpol), tbatch)
        assert got == want, batch


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_specs_match_jax(arch, mesh, cache):
    jcfg, tcfg, _, _ = _shapes(arch)
    batch, seq = CACHES[cache]
    jpol, tpol = _policies(mesh)
    want = _jax_paths(JSH.cache_specs(
        jax.eval_shape(lambda: JM.init_cache(jcfg, batch, seq)), jpol))
    tcache = TM.init_cache(tcfg, batch, seq, device="meta")
    got = _port_paths(SH.cache_specs(tcache, tpol), tcache)
    assert got == want
    names = {p[-1] for p in got}
    if tcfg.family in ("ssm", "hybrid"):
        assert {"conv", "h"} <= names
    if tcfg.family == "encdec":
        assert {"ck", "cv"} <= names


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_spec_matches_jax(mesh, seq_parallel):
    jpol, tpol = _policies(mesh, seq_parallel=seq_parallel)
    want, got = JSH.activation_spec(jpol), SH.activation_spec(tpol)
    if want is None:
        assert got is None
    else:
        assert _norm(got) == _norm(want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_policy_views_match_jax(mesh):
    jpol, tpol = _policies(mesh)
    for name in ("batch_axes", "fsdp_size", "tp_size", "n_devices"):
        assert getattr(tpol, name) == getattr(jpol, name), name
    prod = TMESH.make_production_mesh(multi_pod=mesh == "2x16x16")
    assert SH.ShardingPolicy.for_mesh(prod) == tpol


@pytest.mark.parametrize("mesh", list(MESHES))
def test_microbatch_count_on_the_reference_meshes(mesh):
    """``tests/test_distributed.py::test_microbatch_count_respects_mesh``:
    256 rows on 16 data devices -> 16 microbatches, on 32 -> 8; and more
    batches and requests."""
    jpol, tpol = _policies(mesh)
    for batch, want in ((256, 0), (256, 4), (64, 0), (32, 3), (16, 16),
                        (8, 0)):
        got = TST._microbatch_count(InputShape("t", 4096, batch, "train"),
                                    tpol, want)
        assert got == JST._microbatch_count(JShape("t", 4096, batch, "train"),
                                            jpol, want), (batch, want)
    assert TST._microbatch_count(InputShape("t", 4096, 256, "train"),
                                 tpol) == (16 if mesh == "16x16" else 8)
