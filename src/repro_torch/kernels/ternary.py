"""TernGrad 2-bit codec on Hopper: build, bind and launch ``csrc/ternary.cu``.

Replaces the Pallas kernels ``repro/kernels/ternary.py::_encode_kernel`` and
``::_decode_kernel``; the source's header note gives the design and its
bound. The kernels work on a whole gradient at once, every leaf in one
launch, described by a leaf table (``leaf_table``: built once per tuple of
leaf sizes, the leaves' pointers filled in at each call):

- ``ef_compress_leaves``: error feedback over a gradient, c = g + r, its
  per-leaf scale, the packed codes, the decoded values and the residual
  c - decoded, in two launches (the scale pass, then the codes);
- ``encode_leaves``: the packed codes and scales of a gradient, in two
  launches, or one where the scales are given;
- ``decode_leaves``: the decoded gradient from packed codes and scales, in
  one launch.

These hold the codec's contract (every code 0 where the scale is inf or
NaN, as the JAX codec). ``ternary_encode`` and ``ternary_decode`` are the
counterparts of the two Pallas bodies, one leaf of N % 4 == 0 values with a
given scale and the Pallas comparison ``|g| >= s/2``: the one-leaf case of
the same kernels. Outputs of a gradient-level call are views into one
buffer, each leaf's packed view exactly ``ceil(n/4)`` bytes.

Each wrapper counts the launches it makes, so a run can show that its path
went through the kernels: ``ternary_encode.launches`` (the encode kernel
and the scale pass before it, from ``ternary_encode`` and
``encode_leaves``), ``ternary_decode.launches`` (``ternary_decode`` and
``decode_leaves``) and ``ef_compress_leaves.launches`` (its scale pass and
its encode-decode-residual kernel: 2 a gradient of up to 64 leaves).
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build as kbuild

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ternary.cu"

STEP = 1024            # elements a block covers a step (256 threads x 4)
MIN_SPAN = 4096        # elements a block covers at least
MAX_BLOCKS = 1024      # blocks a leaf takes at most (its partials)
MAX_LEAVES = 64        # leaves a launch's table holds
PAD = 16               # each leaf is padded to a multiple of 16 elements
MIN_SCALE = 1e-12      # the codec's clamp of s
_SCALE, _ENCODE, _EF, _DECODE = range(4)
_CODEC = 1             # flag: codes gated on isfinite(s)


class _Leaf(ctypes.Structure):
    """Mirror of ``Leaf`` in ternary.cu (56 bytes)."""
    _fields_ = [("src", ctypes.c_void_p), ("r", ctypes.c_void_p),
                ("s", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("off", ctypes.c_longlong), ("block0", ctypes.c_int),
                ("nblocks", ctypes.c_int), ("span", ctypes.c_int),
                ("pad_", ctypes.c_int)]


class _Table(ctypes.Structure):
    """Mirror of ``Table`` in ternary.cu."""
    _fields_ = [("partial", ctypes.c_void_p), ("packed", ctypes.c_void_p),
                ("s_out", ctypes.c_void_p), ("dec", ctypes.c_void_p),
                ("res", ctypes.c_void_p), ("n_leaves", ctypes.c_int),
                ("flags", ctypes.c_int), ("leaf", _Leaf * MAX_LEAVES)]


assert ctypes.sizeof(_Leaf) == 56


@functools.cache
def build():
    """Compile (once per source hash) and load the kernel library; the
    bound C launcher."""
    fn = kbuild.load(SOURCE).ternary_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@dataclass(frozen=True)
class _Group:
    """The leaves of one launch: first, count, blocks and the filled
    ctypes table of their sizes, offsets and blocks (pointers left 0)."""
    first: int
    count: int
    blocks: int
    block_base: int            # this launch's first partial
    table: _Table


@dataclass(frozen=True)
class LeafTable:
    """How a gradient of leaves of these sizes is laid out and cut into
    blocks: each leaf's elements, its offset into the padded concatenation
    (``offsets``, a multiple of 16, in elements; in the packed stream the
    byte offset is ``offsets // 4``), its blocks (``block0``: the first, in
    the launch of its group; ``nblocks``; ``span``: elements a block
    covers) and the launches (``groups``, up to 64 leaves each)."""
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    block0: Tuple[int, ...]
    nblocks: Tuple[int, ...]
    spans: Tuple[int, ...]
    total: int                 # padded elements of the concatenation
    n_blocks: int              # over every launch
    groups: Tuple[_Group, ...]

    def views(self, flat, shapes=None, base=0, unit=1):
        """Each leaf's part of ``flat``, laid out like the concatenation
        from element ``base`` on: ``unit`` elements of ``flat`` an element
        of the gradient (1 for fp32 values, 1/4 for packed bytes), shaped
        as ``shapes`` (else flat)."""
        if shapes is None:
            shapes = [(math.ceil(n * unit),) for n in self.sizes]
        return [flat.as_strided(sh, _strides(sh), base + int(off * unit))
                for sh, off in zip(shapes, self.offsets)]


@functools.lru_cache(maxsize=256)
def _strides(shape):
    out, step = [], 1
    for d in reversed(shape):
        out.append(step)
        step *= d
    return tuple(reversed(out))


def _blocks(n):
    """(blocks, span) of a leaf of n elements: 1 to MAX_BLOCKS blocks of
    at least MIN_SPAN elements, each span a multiple of STEP."""
    padded = -(-n // PAD) * PAD
    nb = min(MAX_BLOCKS, -(-padded // MIN_SPAN))
    span = -(-(-(-padded // nb)) // STEP) * STEP
    return -(-padded // span), span


@functools.lru_cache(maxsize=64)
def leaf_table(sizes: Tuple[int, ...]) -> LeafTable:
    """The layout and blocks of a gradient with leaves of these element
    counts (each at least 1), cached by the sizes: a gradient keeps its
    shapes from map to map."""
    if not sizes or min(sizes) < 1:
        raise ValueError(f"ternary kernels: leaf sizes {sizes}, want one or "
                         f"more leaves of at least 1 element")
    offsets, block0, nblocks, spans, groups = [], [], [], [], []
    off = 0
    for first in range(0, len(sizes), MAX_LEAVES):
        count = min(MAX_LEAVES, len(sizes) - first)
        table = _Table()
        table.n_leaves = count
        b = 0
        for j in range(count):
            n = sizes[first + j]
            nb, span = _blocks(n)
            offsets.append(off)
            block0.append(b)
            nblocks.append(nb)
            spans.append(span)
            leaf = table.leaf[j]
            leaf.n, leaf.off, leaf.block0, leaf.nblocks, leaf.span = \
                n, off, b, nb, span
            off += -(-n // PAD) * PAD
            b += nb
        base = sum(g.blocks for g in groups)
        groups.append(_Group(first, count, b, base, table))
    return LeafTable(tuple(sizes), tuple(offsets), tuple(block0),
                     tuple(nblocks), tuple(spans), off,
                     sum(g.blocks for g in groups), tuple(groups))


# ---------------------------------------------------------------------------
# checks (the device check last, so every other refusal shows without a card)
# ---------------------------------------------------------------------------

def _check(name, x, dtype, s, multiple=1):
    """One leaf of a single-leaf wrapper."""
    if not isinstance(x, torch.Tensor) or not isinstance(s, torch.Tensor):
        raise TypeError(f"{name} kernel: takes torch tensors")
    if x.dtype != dtype:
        raise ValueError(f"{name} kernel: input is {x.dtype}, want {dtype}")
    if s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"{name} kernel: scale must be one float32 value, "
                         f"got {s.dtype}{list(s.shape)}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name} kernel: input must be 1-D and contiguous")
    n = x.numel()
    if n == 0:
        raise ValueError(f"{name} kernel: 0 elements, want at least 1")
    if n % multiple:
        raise ValueError(f"{name} kernel: N={n} is not a multiple of "
                         f"{multiple}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel: input is on {x.device}, not a CUDA "
                         f"device")
    if s.device != x.device:
        raise ValueError(f"{name} kernel: scale on {s.device}, input on "
                         f"{x.device}")


def _check_leaves(name, role, ts, dtype, sizes=None):
    """One list of leaves of a gradient-level wrapper: every tensor
    contiguous and of ``dtype``, with ``sizes[i]`` elements where given.
    Returns the leaves' sizes."""
    if not isinstance(ts, (list, tuple)) or not ts:
        raise ValueError(f"{name}: {role} is not a non-empty list of leaves")
    if sizes is not None and len(ts) != len(sizes):
        raise ValueError(f"{name}: {role} holds {len(ts)} leaves, want "
                         f"{len(sizes)}")
    for i, t in enumerate(ts):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {role}[{i}] is not a tensor")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {role}[{i}] is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {role}[{i}] must be contiguous")
        if sizes is not None and t.numel() != sizes[i]:
            raise ValueError(f"{name}: {role}[{i}] holds {t.numel()} "
                             f"elements, want {sizes[i]}")
    return tuple(t.numel() for t in ts)


def _device(name, **lists):
    """The one CUDA device every leaf of ``lists`` is on, or raise."""
    dev = next(iter(lists.values()))[0].device
    for role, ts in lists.items():
        for i, t in enumerate(ts):
            if t.device.type != "cuda":
                raise ValueError(f"{name}: {role}[{i}] is on {t.device}, not "
                                 f"a CUDA device")
            if t.device != dev:
                raise ValueError(f"{name}: {role}[{i}] on {t.device}, the "
                                 f"first leaf on {dev}")
    return dev


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _outputs(tab: LeafTable, dev, fp32_arrays: int):
    """A call's outputs in two allocations: fp32 ``fp32_arrays`` arrays laid
    out like the concatenation, then the scales and the partials; and the
    packed codes. Returns (fp32 buffer, packed buffer)."""
    n = fp32_arrays * tab.total + len(tab.sizes) + tab.n_blocks
    return (kbuild.empty(n, dtype=torch.float32, device=dev),
            kbuild.empty(tab.total // 4, dtype=torch.uint8, device=dev))


def _launch(kernel, table, blocks, dev, counter):
    fn, idx = build(), dev.index
    if idx == torch.cuda.current_device():
        err = fn(kernel, ctypes.addressof(table), blocks,
                 torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(kernel, ctypes.addressof(table), blocks,
                     torch._C._cuda_getCurrentRawStream(idx))
    if err != 0:
        raise RuntimeError(f"ternary kernel {kernel} launch failed: CUDA "
                           f"error {err} ({blocks} blocks)")
    counter.launches += 1


def _run(tab, dev, flags, kernels, f32, packed, n_fp32, *, src, r=None,
         s=None):
    """Fill each group's table with this call's pointers (outputs in
    ``f32`` and ``packed`` as ``_outputs`` lays them out) and launch
    ``kernels`` [(kernel, counter)] over it, group by group."""
    base = f32.data_ptr()
    scales = base + 4 * n_fp32 * tab.total
    partials = scales + 4 * len(tab.sizes)
    for g in tab.groups:
        t = _Table.from_buffer_copy(g.table)
        t.partial = partials + 4 * g.block_base
        t.packed, t.s_out = packed.data_ptr(), scales + 4 * g.first
        t.dec, t.res, t.flags = base, base + 4 * tab.total, flags
        leaves = t.leaf
        for j in range(g.count):
            i, leaf = g.first + j, leaves[j]
            leaf.src = src[i].data_ptr()
            if r is not None:
                leaf.r = r[i].data_ptr()
            if s is not None:
                leaf.s = s[i].data_ptr()
        for kernel, counter in kernels:
            _launch(kernel, t, g.blocks, dev, counter)


def _scales(tab, f32, n_fp32):
    return [f32.as_strided((), (), n_fp32 * tab.total + i)
            for i in range(len(tab.sizes))]


def ef_compress_leaves(gs: Sequence[torch.Tensor], rs: Sequence[torch.Tensor],
                       payload: bool = False):
    """Error feedback over a gradient on the card: gs and rs fp32 leaves
    (contiguous, any shape, rs like gs), one device. Returns (decoded,
    residual) per leaf, shaped like gs, views into one buffer: s = max|g +
    r| clamped to 1e-12 (NaN kept), the codes of g + r gated on
    isfinite(s), decoded = code * s, residual = g + r - decoded. With
    ``payload``, (packed [ceil(n/4)] uint8, s, decoded, residual). Two
    launches per 64 leaves."""
    sizes = _check_leaves("ef_compress_leaves", "g", gs, torch.float32)
    _check_leaves("ef_compress_leaves", "r", rs, torch.float32, sizes)
    dev = _device("ef_compress_leaves", g=gs, r=rs)
    tab = leaf_table(sizes)
    f32, packed = _outputs(tab, dev, 2)
    _run(tab, dev, _CODEC, ((_SCALE, ef_compress_leaves),
                            (_EF, ef_compress_leaves)),
         f32, packed, 2, src=gs, r=rs)
    shapes = [g.shape for g in gs]
    out = (tab.views(f32, shapes), tab.views(f32, shapes, tab.total))
    if payload:
        return (tab.views(packed, unit=0.25), _scales(tab, f32, 2)) + out
    return out


def encode_leaves(gs: Sequence[torch.Tensor],
                  scales: Optional[Sequence[torch.Tensor]] = None):
    """The packed codes of a gradient on the card: gs fp32 leaves
    (contiguous, any shape), one device. Without ``scales`` each leaf's
    scale is max|g| clamped to 1e-12 (NaN kept), found by a scale pass;
    with them (one fp32 value a leaf) they are used as given. Codes gated
    on isfinite(s). Returns (packed [ceil(n/4)] uint8, s) per leaf."""
    sizes = _check_leaves("encode_leaves", "g", gs, torch.float32)
    lists = {"g": gs}
    if scales is not None:
        _check_leaves("encode_leaves", "scales", scales, torch.float32,
                      (1,) * len(sizes))
        lists["scales"] = scales
    dev = _device("encode_leaves", **lists)
    tab = leaf_table(sizes)
    f32, packed = _outputs(tab, dev, 0)
    kernels = ((_ENCODE, ternary_encode),) if scales is not None else \
        ((_SCALE, ternary_encode), (_ENCODE, ternary_encode))
    _run(tab, dev, _CODEC, kernels, f32, packed, 0, src=gs, s=scales)
    return tab.views(packed, unit=0.25), \
        list(scales) if scales is not None else _scales(tab, f32, 0)


def decode_leaves(packed: Sequence[torch.Tensor],
                  scales: Sequence[torch.Tensor], shapes):
    """The decoded gradient on the card: packed uint8 leaves
    [ceil(n_i/4)] (n_i elements of ``shapes[i]``), one fp32 scale a leaf,
    one device. Returns fp32 ``shapes[i]`` per leaf (code * s), views into
    one buffer; one launch per 64 leaves."""
    shapes = [tuple(int(d) for d in sh) for sh in shapes]
    sizes = tuple(math.prod(sh) for sh in shapes)
    _check_leaves("decode_leaves", "packed", packed, torch.uint8,
                  tuple(-(-n // 4) for n in sizes))
    _check_leaves("decode_leaves", "scales", scales, torch.float32,
                  (1,) * len(sizes))
    dev = _device("decode_leaves", packed=packed, scales=scales)
    tab = leaf_table(sizes)
    f32, packed_out = _outputs(tab, dev, 1)
    _run(tab, dev, _CODEC, ((_DECODE, ternary_decode),), f32, packed_out, 1,
         src=packed, s=scales)
    return tab.views(f32, shapes)


def ternary_encode(g_flat, s):
    """g_flat fp32 [N] (N % 4 == 0), s one fp32 value, both on one CUDA
    device -> packed uint8 [N/4], by the Pallas comparison |g| >= s/2 (no
    gate on s). Raises on any other input."""
    _check("ternary_encode", g_flat, torch.float32, s, multiple=4)
    tab = leaf_table((g_flat.numel(),))
    f32, packed = _outputs(tab, g_flat.device, 0)
    _run(tab, g_flat.device, 0, ((_ENCODE, ternary_encode),), f32, packed, 0,
         src=[g_flat], s=[s])
    return packed[:g_flat.numel() // 4]


def ternary_decode(packed, s):
    """packed uint8 [N/4], s one fp32 value, both on one CUDA device ->
    fp32 [N] of code * s (+s, -s, and 0 * s: +0.0 for a finite s > 0).
    Raises on any other input."""
    _check("ternary_decode", packed, torch.uint8, s)
    return decode_leaves([packed], [s], [(4 * packed.numel(),)])[0]


ternary_encode.launches = 0
ternary_decode.launches = 0
ef_compress_leaves.launches = 0
