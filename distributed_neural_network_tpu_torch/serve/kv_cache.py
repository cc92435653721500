"""Block/paged KV-cache allocator for the serving engine.

A copy of the JAX package's `serve/kv_cache.py` (numpy only); the tests
hold the two against each other. Its notes speak of the JAX engine's jitted
steps; the port's engine (`serve/engine.py`) keeps the same pools as
persistent tensors updated in place.

The training-side decode path (`models/transformer.py generate`)
allocates one contiguous ``(L, B, H, total, Dh)`` cache per batch -
every sequence pays for ``total`` slots up front, so a mixed-length
serving batch wastes HBM proportional to the spread between the longest
request and everyone else, and admission is limited by the WORST case.
This module is the serving answer (the vLLM/PagedAttention idea, cast
into this repo's static-shape jit discipline):

- one shared device pool of ``num_blocks`` fixed-size blocks per layer,
  laid out flat as ``(L, num_blocks * block_size, H, Dh)`` so a block
  table turns into plain integer gather/scatter indices - the jitted
  decode step keeps ONE static shape per (batch, table-width) bucket;
- a host-side free-list allocator: sequences take blocks one at a time
  as their position crosses a block boundary and return them all on
  retirement - internal fragmentation is bounded by ``block_size - 1``
  tokens per live sequence, external fragmentation is zero by
  construction (all blocks are interchangeable);
- ``OutOfBlocks`` is the backpressure signal, not a crash: the engine
  parks the sequence (a ``kv_alloc_stall`` ledger second), the
  scheduler stops admitting, and - if nothing at all can run - the
  youngest sequence is preempted back to the queue, its blocks freed.

Block id 0 is reserved as a scratch block: table rows are padded with
it (reads beyond a sequence's live range are masked to -inf before
softmax, so the values never matter), and inactive batch slots scatter
their dead writes into it. The allocator therefore hands out ids
``1..num_blocks-1``.

Pure host bookkeeping + index math; the device pools live on
`ServeEngine` (functionally updated by the jitted step). Stdlib+numpy
only, importable without jax.

Under ``EngineConfig.kv_dtype="int8"`` the device pools are stored
QUANTIZED - int8 codes plus one f32 scale per (block, head) per layer -
using the same block ids this allocator hands out (scale of slot ``s``
= ``scales[table[s // block_size]]``), which roughly doubles how many
concurrent sequences one HBM budget holds (`analysis/cost.py
kv_block_bytes` prices it exactly; docs/SERVING.md "int8 KV cache").
The allocator itself is dtype-blind; the engine zeroes a freed block's
scales so reuse is history-free (deterministic preemption replay).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

# block id every table row is padded with and every inactive slot
# writes to; never allocated
SCRATCH_BLOCK = 0


class OutOfBlocks(Exception):
    """The pool has no free block - the admission/scheduling
    backpressure signal (never a crash in the serving path)."""

    def __init__(self, need: int, free: int, total: int):
        self.need, self.free, self.total = need, free, total
        super().__init__(
            f"KV pool exhausted: need {need} block(s), {free} free of "
            f"{total} usable - admission should back off (429) or a "
            "sequence must be preempted"
        )


@dataclass(frozen=True)
class KVCacheConfig:
    """Pool geometry. ``num_blocks`` INCLUDES the reserved scratch
    block, so ``usable_blocks = num_blocks - 1``; ``max_seq_len`` bounds
    any sequence's prompt+generation and sizes the widest block table
    (``max_blocks_per_seq``)."""

    num_blocks: int = 64
    block_size: int = 16
    max_seq_len: int = 512

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (one scratch + one usable), "
                f"got {self.num_blocks}"
            )
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.max_seq_len < 1:
            raise ValueError(
                f"max_seq_len must be >= 1, got {self.max_seq_len}"
            )

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)  # ceil div

    @property
    def pool_slots(self) -> int:
        """Flat token-slot count of the device pool's second axis."""
        return self.num_blocks * self.block_size

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.block_size)


class PagedKVCache:
    """Host-side block allocator + table builder (thread-safe: the HTTP
    admission path asks `can_fit` while the engine thread allocates)."""

    def __init__(self, cfg: KVCacheConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        # LIFO free list: a just-freed (cache-hot) block is reused first
        self._free = list(range(cfg.num_blocks - 1, SCRATCH_BLOCK, -1))
        self._seq_blocks: dict[int, list[int]] = {}
        self._seq_used: dict[int, int] = {}  # tokens written (pos + 1)
        self.alloc_total = 0
        self.free_total = 0

    # ------------------------------------------------------------ queries

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        with self._lock:
            return self.cfg.usable_blocks - len(self._free)

    def utilization(self) -> float:
        return self.blocks_in_use / self.cfg.usable_blocks

    def can_fit(self, n_tokens: int) -> bool:
        """Would a fresh sequence of ``n_tokens`` find blocks right now?
        Advisory (the engine thread may race it); admission uses it as
        the cheap first gate before the queue."""
        return self.cfg.blocks_for_tokens(n_tokens) <= self.free_blocks

    def seq_block_ids(self, seq_id: int) -> list[int]:
        with self._lock:
            return list(self._seq_blocks.get(seq_id, ()))

    def waste_slots(self) -> int:
        """Allocated-but-unwritten token slots across live sequences -
        the internal fragmentation, bounded by
        ``(block_size - 1) * live_sequences`` (tested)."""
        with self._lock:
            total = 0
            for sid, blocks in self._seq_blocks.items():
                total += len(blocks) * self.cfg.block_size - self._seq_used.get(
                    sid, 0
                )
            return total

    # --------------------------------------------------------- allocation

    def ensure(self, seq_id: int, pos: int) -> None:
        """Guarantee a block exists for token position ``pos`` of
        ``seq_id`` (allocating at most one - positions advance by one
        token at a time; chunked prefill calls this per position in the
        chunk). Raises `OutOfBlocks` without mutating anything."""
        if pos >= self.cfg.max_seq_len:
            raise ValueError(
                f"position {pos} exceeds max_seq_len {self.cfg.max_seq_len}"
            )
        need_blocks = pos // self.cfg.block_size + 1
        with self._lock:
            blocks = self._seq_blocks.setdefault(seq_id, [])
            if len(blocks) < need_blocks:
                if not self._free:
                    raise OutOfBlocks(
                        1, 0, self.cfg.usable_blocks
                    )
                blocks.append(self._free.pop())
                self.alloc_total += 1
            if pos + 1 > self._seq_used.get(seq_id, 0):
                self._seq_used[seq_id] = pos + 1

    def ensure_range(self, seq_id: int, end_pos: int) -> None:
        """`ensure` every position up to ``end_pos`` inclusive (the
        chunked-prefill span). All-or-nothing: on OutOfBlocks the blocks
        already held are KEPT (they hold written history), but no
        partial allocation for the new span leaks."""
        need = end_pos // self.cfg.block_size + 1
        if end_pos >= self.cfg.max_seq_len:
            raise ValueError(
                f"position {end_pos} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}"
            )
        with self._lock:
            blocks = self._seq_blocks.setdefault(seq_id, [])
            missing = need - len(blocks)
            if missing > len(self._free):
                raise OutOfBlocks(
                    missing, len(self._free), self.cfg.usable_blocks
                )
            for _ in range(max(missing, 0)):
                blocks.append(self._free.pop())
                self.alloc_total += 1
            if end_pos + 1 > self._seq_used.get(seq_id, 0):
                self._seq_used[seq_id] = end_pos + 1

    def rewind(self, seq_id: int, n_tokens: int) -> list[int]:
        """Roll ``seq_id``'s write cursor back to ``n_tokens`` tokens
        written, returning any trailing blocks past
        ``blocks_for_tokens(n_tokens)`` to the pool (newest first, so
        the LIFO free list reuses them immediately). Returns the freed
        block ids so the engine can zero their int8 scales - the same
        history-free-reuse contract `free` has.

        This is the cursor-rewind speculative decoding relies on: a
        verify step writes k+1 positions optimistically, then the host
        rewinds past the rejected suffix. It is exactly the bookkeeping
        preemption replay performs (free + re-ensure), just partial, so
        replay determinism carries over unchanged. Growing the cursor is
        not this primitive's job (``n_tokens`` above the current count
        is a ValueError, not a silent alloc)."""
        if n_tokens < 0:
            raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
        keep = self.cfg.blocks_for_tokens(n_tokens)
        with self._lock:
            blocks = self._seq_blocks.get(seq_id)
            if blocks is None:
                return []
            used = self._seq_used.get(seq_id, 0)
            if n_tokens > used:
                raise ValueError(
                    f"rewind({seq_id}, {n_tokens}) would grow the "
                    f"cursor (currently {used} tokens written)"
                )
            freed = blocks[keep:]
            del blocks[keep:]
            # newest-written first onto the LIFO list (pop() reuses the
            # cache-hot block next), mirroring free()'s ordering intent
            self._free.extend(reversed(freed))
            self.free_total += len(freed)
            if n_tokens:
                self._seq_used[seq_id] = n_tokens
            else:
                self._seq_used.pop(seq_id, None)
                if not blocks:
                    self._seq_blocks.pop(seq_id, None)
            return freed

    def free(self, seq_id: int) -> int:
        """Return all of ``seq_id``'s blocks to the pool (retirement,
        cancel, preemption); returns how many were freed. Unknown ids
        are a no-op (idempotent - cancel can race retirement)."""
        with self._lock:
            blocks = self._seq_blocks.pop(seq_id, [])
            self._seq_used.pop(seq_id, None)
            # append in allocation order so pop() (the next alloc) hands
            # back the most recently written block first (LIFO)
            self._free.extend(blocks)
            self.free_total += len(blocks)
            return len(blocks)

    # ------------------------------------------------------------- tables

    def table(self, seq_ids, width: int) -> np.ndarray:
        """``(len(seq_ids), width)`` int32 block table, rows padded with
        the scratch block. ``width`` must cover every sequence's
        allocated blocks (the engine picks the bucket)."""
        out = np.full((len(seq_ids), width), SCRATCH_BLOCK, np.int32)
        with self._lock:
            for i, sid in enumerate(seq_ids):
                blocks = self._seq_blocks.get(sid, ())
                if len(blocks) > width:
                    raise ValueError(
                        f"table width {width} < {len(blocks)} allocated "
                        f"blocks for seq {sid}"
                    )
                out[i, : len(blocks)] = blocks
        return out

    def max_blocks_live(self) -> int:
        """Widest live sequence in blocks (the width-bucket input)."""
        with self._lock:
            return max(
                (len(b) for b in self._seq_blocks.values()), default=0
            )
