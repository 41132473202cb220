"""Real-text LM data: the committed corpus ``data/corpus.txt.gz``
(counterpart of psgd_torch_tpu/models/lm_data.py, whose docstring gives
its provenance: license prose and open-source Python sources, the stand-in
for the reference's WikiText-103, misc/gpt2.py:40-76).

Tokenization: word-level (words, punctuation, newlines), frequency-ranked
vocab capped at the model's vocab size, deterministic, in numpy; the same
ids as the JAX module.  Batches are random contiguous windows drawn from a
``torch.Generator`` (a fresh batch per step, as the reference's
``get_batch``, misc/gpt2.py:78-90).
"""

from __future__ import annotations

import gzip
import os
import re
from collections import Counter
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device

_CORPUS = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                       "corpus.txt.gz")
_TOKEN_RE = re.compile(r"\w+|[^\w\s]|\n")


@lru_cache(maxsize=2)
def load_tokens(vocab_size: int, path: Optional[str] = None,
                val_fraction: float = 0.05):
    """Returns (train_tokens, val_tokens, vocab_used) as numpy int32: id 0
    is <unk>, the rest the vocab_size - 1 most frequent tokens."""
    with gzip.open(path or _CORPUS, "rt", encoding="utf-8",
                   errors="ignore") as f:
        words = _TOKEN_RE.findall(f.read())
    vocab = [w for w, _ in Counter(words).most_common(vocab_size - 1)]
    ids = {w: i + 1 for i, w in enumerate(vocab)}
    toks = np.fromiter((ids.get(w, 0) for w in words), dtype=np.int32,
                       count=len(words))
    n_val = max(int(len(toks) * val_fraction), 1)
    return toks[:-n_val], toks[-n_val:], len(vocab) + 1


def corpus_batch(generator: torch.Generator, tokens: np.ndarray, batch: int,
                 seq_len: int, device=None,
                 starts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random contiguous windows (tokens, next-token targets), (batch,
    seq_len) int64 on ``device`` (the card unless the caller asks for the
    CPU).  Starts are uniform in [0, len(tokens) - seq_len - 1), drawn on
    the CPU from ``generator``, or the given ``starts``."""
    dev = resolve_device(device)
    if starts is None:
        starts = torch.randint(0, tokens.size - seq_len - 1, (batch,),
                               generator=generator)
    idx = torch.as_tensor(starts, dtype=torch.int64)[:, None] + \
        torch.arange(seq_len + 1)[None, :]
    win = torch.from_numpy(tokens)[idx].to(torch.int64).to(dev)
    return win[:, :-1], win[:, 1:]
