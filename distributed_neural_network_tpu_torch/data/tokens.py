"""Token-stream dataset for the LM family: a corpus file -> (B, S) batches.

A copy of the JAX package's `data/tokens.py` (pure numpy there as here; the
JAX package cannot be imported without JAX, so the port keeps its own copy):
a flat token stream (.npy, raw .bin, or .txt as bytes) stays a numpy memmap;
a batch is B windows of S+1 tokens at offsets drawn from a Generator keyed
by (seed, split, step), so any batch is reproducible in isolation; the
stream's tail is the held-out split. Without a path, a synthetic copy-task
stream from a seeded numpy Generator stands in.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

_SUPPORTED = {
    np.dtype(np.uint16): np.uint16,
    np.dtype(np.uint32): np.uint32,
    np.dtype(np.int32): np.int32,
    np.dtype(np.int64): np.int64,
}


@dataclass(frozen=True)
class TokenStream:
    """A flat token stream plus its train/eval boundary."""

    tokens: np.ndarray  # 1-D, integer dtype (often a memmap)
    n_train: int  # tokens [0, n_train) are the train split
    vocab_size: int
    source: str  # "npy" | "bin" | "txt" | "synthetic"

    @property
    def n_eval(self) -> int:
        return len(self.tokens) - self.n_train


def load_token_stream(
    path: str | None,
    *,
    vocab_size: int,
    eval_frac: float = 0.05,
    bin_dtype: str = "uint16",
    synthetic_tokens: int = 1 << 16,
    seed: int = 0,
) -> TokenStream:
    """Load a token corpus, or synthesize one when `path` is None/missing.

    `path` may be a .npy (any supported integer dtype) or a raw .bin of
    `bin_dtype` tokens. Values must be < vocab_size (checked on a sample,
    fully lazily for memmaps). The trailing `eval_frac` of the stream is
    reserved as the held-out split.
    """
    if not 0.0 <= eval_frac < 1.0:
        raise ValueError(f"eval_frac must be in [0, 1), got {eval_frac}")
    if path and os.path.exists(path):
        if path.endswith(".npy"):
            arr = np.load(path, mmap_mode="r")
            source = "npy"
        elif path.endswith(".txt"):
            # byte-level tokenization IS a uint8 memmap of the text file:
            # zero-copy, no tokenizer dependency; needs vocab_size >= 256
            if vocab_size < 256:
                raise ValueError(
                    f".txt corpora are byte-tokenized (ids 0-255); "
                    f"vocab_size must be >= 256, got {vocab_size}"
                )
            arr = np.memmap(path, dtype=np.uint8, mode="r")
            source = "txt"
        else:
            arr = np.memmap(path, dtype=np.dtype(bin_dtype), mode="r")
            source = "bin"
        if arr.ndim != 1:
            raise ValueError(
                f"token file must be 1-D, got shape {arr.shape} ({path})"
            )
        if source != "txt" and arr.dtype not in _SUPPORTED:
            raise ValueError(
                f"unsupported token dtype {arr.dtype} ({path}); use one of "
                f"{sorted(str(d) for d in _SUPPORTED)}"
            )
        # cheap sanity probe on a deterministic sample (full scan of a
        # 100 GB memmap would defeat the point of memmapping)
        probe = np.asarray(
            arr[np.linspace(0, len(arr) - 1, num=min(4096, len(arr)),
                            dtype=np.int64)]
        )
        if probe.size and int(probe.max()) >= vocab_size:
            raise ValueError(
                f"token id {int(probe.max())} >= vocab_size {vocab_size} "
                f"in {path}"
            )
    else:
        if path:
            raise FileNotFoundError(
                f"token file {path!r} not found (pass --data-path to an "
                "existing .npy/.bin/.txt or omit it for the synthetic "
                "stream)"
            )
        # synthetic: concatenated copy-task sequences so the LM objective
        # is learnable and convergence is observable without a corpus
        rng = np.random.default_rng(seed)
        half = 64
        n_seq = max(synthetic_tokens // (2 * half), 1)
        first = rng.integers(2, vocab_size, size=(n_seq, half))
        arr = np.concatenate([first, first], axis=1).reshape(-1)
        arr = arr.astype(np.uint32)
        source = "synthetic"
    n_eval = int(len(arr) * eval_frac)
    return TokenStream(
        tokens=arr, n_train=len(arr) - n_eval, vocab_size=vocab_size,
        source=source,
    )


def _window_starts(
    rng: np.random.Generator, lo: int, hi: int, batch: int
) -> np.ndarray:
    if hi <= lo:
        raise ValueError(
            f"split has too few tokens for this seq_len (window range "
            f"[{lo}, {hi}))"
        )
    return rng.integers(lo, hi, size=batch)


def sample_batch(
    stream: TokenStream,
    *,
    batch: int,
    seq_len: int,
    step: int,
    seed: int = 0,
    split: str = "train",
):
    """(tokens, targets) int32 (batch, seq_len) for `step` of `split`.

    Windows are contiguous slices of seq_len + 1 tokens at offsets drawn
    from a Generator keyed by (seed, split, step) - stateless, so resume
    at step k reproduces exactly the batches a fresh run would see.
    """
    if split == "train":
        lo, hi = 0, stream.n_train - seq_len - 1
    elif split == "eval":
        lo, hi = stream.n_train, len(stream.tokens) - seq_len - 1
    else:
        raise ValueError(f"split must be 'train' or 'eval', got {split!r}")
    # fixed per-split constants: Python's hash() is salted per process
    # (PYTHONHASHSEED), which would silently void the cross-process
    # determinism this function guarantees
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, {"train": 0, "eval": 1}[split], step])
    )
    starts = _window_starts(rng, lo, hi, batch)
    idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
    w = np.asarray(stream.tokens[idx], dtype=np.int32)
    return w[:, :-1], w[:, 1:]
