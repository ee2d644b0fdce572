"""Character-level text pipeline — the paper's workload data path.

The paper trains on "TensorFlow.js code (compiled, 0.11.7)" — i.e., the system's
own source text. We do exactly the analogous thing: the default corpus is this
repository's own Python source, concatenated deterministically (sorted paths).
In the port that is the source of the reference package ``src/repro`` — the
same text, so the same vocabulary and batches, as the JAX run. A seeded
synthetic corpus is provided for hermetic tests.

The batch schedule is a pure function of (seed, epoch, batch) so the sequential
baseline, the L1 volunteer runtime, and the L2 SPMD mapping all consume the
*identical* sample stream — this is what makes the paper's Table-4 invariance
(same loss for every worker count) testable as an exact equality.
"""
from __future__ import annotations

import hashlib
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


# the reference package's source text, read as data (never imported): both
# packages then train on one corpus with one vocabulary
REFERENCE_SRC = pathlib.Path(__file__).resolve().parents[2] / "repro"


def repo_corpus(root: str | None = None, max_chars: int = 200_000) -> str:
    """Concatenate the reference package's source files (sorted), like the
    paper trained on tfjs's own code."""
    base = pathlib.Path(root) if root else REFERENCE_SRC
    parts: List[str] = []
    total = 0
    for p in sorted(base.rglob("*.py")):
        try:
            t = p.read_text(errors="ignore")
        except OSError:
            continue
        parts.append(t)
        total += len(t)
        if total >= max_chars:
            break
    text = "".join(parts)[:max_chars]
    if len(text) < 10_000:  # safety: never return a degenerate corpus
        text = (text + synthetic_corpus(10_000 - len(text)))
    return text


def synthetic_corpus(n_chars: int = 50_000, seed: int = 7) -> str:
    """Deterministic pseudo-code text (hermetic fallback for tests)."""
    rng = np.random.RandomState(seed)
    words = ["const", "let", "function", "return", "tensor", "model", "train",
             "gradient", "queue", "task", "reduce", "map", "worker", "async",
             "await", "batch", "epoch", "loss", "browser", "volunteer"]
    out: List[str] = []
    n = 0
    while n < n_chars:
        w = words[rng.randint(len(words))]
        frag = f"{w}({rng.randint(100)});\n" if rng.rand() < 0.3 else f"{w} "
        out.append(frag)
        n += len(frag)
    return "".join(out)[:n_chars]


@dataclass
class CharVocab:
    chars: str

    @classmethod
    def from_text(cls, text: str) -> "CharVocab":
        return cls("".join(sorted(set(text))))

    @property
    def size(self) -> int:
        return len(self.chars)

    def encode(self, text: str) -> np.ndarray:
        table = {c: i for i, c in enumerate(self.chars)}
        return np.asarray([table[c] for c in text], np.int32)

    def decode(self, ids) -> str:
        return "".join(self.chars[int(i)] for i in ids)


@dataclass
class TextTask:
    """The full data context for the paper's experiment."""
    ids: np.ndarray          # encoded corpus
    vocab: CharVocab
    sample_len: int
    seed: int = 1234

    @classmethod
    def build(cls, text: str | None = None, sample_len: int = 40,
              seed: int = 1234) -> "TextTask":
        text = text if text is not None else repo_corpus()
        vocab = CharVocab.from_text(text)
        return cls(vocab.encode(text), vocab, sample_len, seed)

    # -- deterministic schedule --------------------------------------------
    def starts(self, epoch: int, batch: int, batch_size: int) -> np.ndarray:
        """Window start offsets for (epoch, batch) — pure function of seed."""
        h = hashlib.sha256(f"{self.seed}:{epoch}:{batch}".encode()).digest()
        rng = np.random.RandomState(int.from_bytes(h[:4], "little"))
        hi = len(self.ids) - self.sample_len - 1
        return rng.randint(0, hi, size=batch_size).astype(np.int64)

    def make_batch(self, starts: np.ndarray) -> Dict[str, np.ndarray]:
        """{'x': one-hot [B, T, V] float32, 'y': next-char ids [B]}."""
        T, V = self.sample_len, self.vocab.size
        idx = starts[:, None] + np.arange(T)[None, :]
        x_ids = self.ids[idx]                                   # [B, T]
        y = self.ids[starts + T]                                # [B]
        x = np.zeros((len(starts), T, V), np.float32)
        np.put_along_axis(x, x_ids[..., None], 1.0, axis=-1)
        return {"x": x, "y": y.astype(np.int32)}

    def batch(self, epoch: int, batch: int, batch_size: int):
        return self.make_batch(self.starts(epoch, batch, batch_size))

    def minibatch(self, epoch: int, batch: int, batch_size: int,
                  mb_index: int, mb_size: int):
        """Slice mini-batch ``mb_index`` out of the batch — the map-task unit.
        Slicing the same schedule guarantees distributed == sequential."""
        starts = self.starts(epoch, batch, batch_size)
        return self.make_batch(starts[mb_index * mb_size:(mb_index + 1) * mb_size])
