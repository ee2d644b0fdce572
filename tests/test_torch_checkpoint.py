"""The port's ``CheckpointStore`` against the JAX package's, on the CPU.

A tree saved by either package loads in the other bit for bit: fp32, int32
and bfloat16 leaves (the port's bfloat16 as a CPU tensor, JAX's as
``ml_dtypes.bfloat16``), the optimizer state's int32 step and the meta. The
file names, ``versions()``, ``latest()`` and ``keep`` retention agree.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro_torch import bridge, tree
from repro_torch.checkpoint.store import CheckpointStore as TStore


def _jax_tree(seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(6, 5).astype(np.float32)
    w[0, :3] = [np.inf, -0.0, np.nan]
    return {"params": {"w": w,
                       "e": np.asarray(jnp.asarray(rng.randn(4, 3))
                                       .astype(jnp.bfloat16)),
                       "stack": {"l0": rng.randn(2, 3, 4).astype(np.float32)}},
            "opt": {"m": {"w": rng.randn(6, 5).astype(np.float32)},
                    "step": np.asarray(3, np.int32)}}


def _bits(a):
    """(dtype name, shape, raw bytes) of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = bridge.to_numpy(a)
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _same_bits(port_leaf, jax_leaf):
    return _bits(port_leaf) == _bits(jax_leaf)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    want = _jax_tree()
    JStore(str(tmp_path)).save(7, want, meta={"step": 7, "arch": "x"})
    got, meta = TStore(str(tmp_path)).load(7)
    assert meta == {"step": 7, "arch": "x"}
    assert got["params"]["e"].dtype == torch.bfloat16
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert _same_bits(g, w)


def test_port_checkpoint_loads_in_jax(tmp_path):
    want = bridge.params_from_jax(_jax_tree(1), "cpu")
    assert want["params"]["e"].dtype == torch.bfloat16
    path = TStore(str(tmp_path)).save(2, want, meta={"step": 2})
    assert path.endswith("v00000002.ckpt")
    got, meta = JStore(str(tmp_path)).load(2)
    assert meta == {"step": 2}
    assert str(np.asarray(got["params"]["e"]).dtype) == "bfloat16"
    assert np.asarray(got["opt"]["step"]).dtype == np.int32
    for w, g in zip(tree.leaves(want), jax.tree.leaves(got), strict=True):
        assert _same_bits(w, g)


def test_port_round_trip_is_bit_equal(tmp_path):
    want = bridge.params_from_jax(_jax_tree(2), "cpu")
    store = TStore(str(tmp_path))
    store.save(1, want)
    got = tree.to_device(store.load(1)[0], "cpu")
    for w, g in zip(tree.leaves(want), tree.leaves(got), strict=True):
        assert w.dtype == g.dtype and _same_bits(w, g)


@pytest.mark.parametrize("keep", [0, 2])
def test_versions_latest_and_keep_agree(tmp_path, keep):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    js, ts = JStore(str(jdir), keep=keep), TStore(str(tdir), keep=keep)
    assert js.latest() is None and ts.latest() is None
    for v in (1, 2, 5, 3):
        js.save(v, {"x": np.zeros(2, np.float32)})
        ts.save(v, {"x": torch.zeros(2)})
        assert ts.versions() == js.versions()
        assert ts.latest() == js.latest()
    assert sorted(p.name for p in tdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    assert not list(tdir.glob("*.tmp"))
