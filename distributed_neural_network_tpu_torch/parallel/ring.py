"""Sequence parallelism: the port of the JAX package's `parallel/ring.py`.

- `attention`: plain full attention on one rank, the local and reference
  form (a single head takes the squeezed 3-D contraction, as in JAX).
- `ring_attention`: each rank of the sequence axis holds one contiguous
  shard of Q/K/V; K/V blocks travel the ring n-1 hops (`ppermute`), and each
  rank accumulates its queries' attention over every block with the online
  softmax (running max ``m``, denominator ``l``, numerator ``acc``).
- `zigzag_order` / `zigzag_inverse` / `zigzag_positions`: the zigzag layout
  (rank i holds chunks i and 2n-1-i of 2n), and `zigzag_ring_attention`,
  the causal ring over it, in which every off-diagonal hop needs two
  half-blocks on every rank.
- `ulysses_attention`: an all-to-all from sequence-sharded to head-sharded
  (each rank then holds H/n whole-sequence heads), full attention, and the
  all-to-all back.

The blocks compute with plain torch ops in the JAX order of operations; no
TPU kernel is involved (the JAX module computes with `jnp.einsum` too). A
sequence axis is a `parallel/mesh.py` `Axis` (size, this rank's index, its
group); its collectives are `parallel/collectives.py` `ppermute` and
`all_to_all`, whose gradients are the JAX transposes, so the functions
differentiate. An axis of size 1 (or None) needs no collective: the ring is
then one local block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .collectives import all_to_all, ppermute

NEG_BIG = -1e30  # large-negative mask value; avoids -inf NaN propagation


def _size_index(axis) -> tuple[int, int]:
    return (1, 0) if axis is None else (axis.size, axis.index)


def attention(q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0,
              scale=None):
    """Plain full attention in the inputs' dtype: q (B, Sq, H, D), k/v (B,
    Sk, H, D) -> (B, Sq, H, D). The offsets are the global positions of row
    0 of q and of k for the causal mask. With one head in all three the
    contraction runs squeezed (3-D), with the same values."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    # all three single-head: squeezing on q alone would attend k/v head 0
    squeeze = q.shape[2] == k.shape[2] == v.shape[2] == 1
    if squeeze:
        s = torch.einsum("bqd,bkd->bqk", q[:, :, 0], k[:, :, 0]) * scale
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_BIG)
    p = torch.softmax(s, dim=-1)
    if squeeze:
        return torch.einsum("bqk,bkd->bqd", p, v[:, :, 0])[:, :, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def ring_attention(q, k, v, axis=None, *, causal: bool = False, scale=None):
    """Exact attention over a sequence sharded across `axis`: q/k/v are this
    rank's (B, S_local, H, D) shards in ring order (shard i holds global
    positions [i*S_local, (i+1)*S_local)); returns this rank's output
    shard. n-1 rotate-and-accumulate hops, then the last block without a
    rotation."""
    n, me = _size_index(axis)
    b, s_local, h, d = q.shape
    scale_ = 1.0 / math.sqrt(d) if scale is None else scale
    qpos = me * s_local + torch.arange(s_local, device=q.device)
    perm = _ring_perm(n)

    def update(i, m, l, acc, k_blk, v_blk):
        src = (me - i) % n
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale_
        if causal:
            kpos = src * s_local + torch.arange(s_local, device=q.device)
            sc = sc.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_BIG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        return m_new, l, acc

    m = torch.full((b, h, s_local), NEG_BIG, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, s_local), dtype=q.dtype, device=q.device)
    acc = torch.zeros((b, h, s_local, d), dtype=q.dtype, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n - 1):
        m, l, acc = update(i, m, l, acc, k_blk, v_blk)
        k_blk = ppermute(k_blk, perm, axis)
        v_blk = ppermute(v_blk, perm, axis)
    m, l, acc = update(n - 1, m, l, acc, k_blk, v_blk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)  # (B, Sq, H, D)


def zigzag_order(s: int, n: int) -> np.ndarray:
    """The permutation that puts a length-s sequence into the zigzag layout:
    cut into 2n equal chunks, rank i's contiguous shard is [chunk i, chunk
    2n-1-i]. int32 indices `perm` with x_zigzag = x[..., perm, :]."""
    if s % (2 * n):
        raise ValueError(f"seq len {s} must divide by 2*n ({2 * n})")
    h = s // (2 * n)
    chunks = np.arange(s).reshape(2 * n, h)
    order = []
    for i in range(n):
        order.append(chunks[i])
        order.append(chunks[2 * n - 1 - i])
    return np.concatenate(order).astype(np.int32)


def zigzag_inverse(s: int, n: int) -> np.ndarray:
    """The inverse of `zigzag_order` (zigzag -> natural)."""
    perm = zigzag_order(s, n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(s, dtype=np.int32)
    return inv


def zigzag_positions(s_local: int, axis=None, device=None) -> torch.Tensor:
    """Global positions of this rank's rows under the zigzag layout."""
    n, i = _size_index(axis)
    h = s_local // 2
    lo = i * h + torch.arange(h, device=device)
    hi = (2 * n - 1 - i) * h + torch.arange(h, device=device)
    return torch.cat([lo, hi])


def zigzag_ring_attention(q, k, v, axis=None, *, scale=None):
    """Causal ring attention over zigzag-sharded sequences (`zigzag_order`):
    the diagonal step is local causal attention as three half-blocks (lo x
    lo causal, hi x lo full, hi x hi causal); every later hop with K/V of
    rank src takes two unmasked half-blocks, chosen by whether src's chunks
    come before this rank's (src < me) or after. q/k/v: this rank's zigzag
    shards (B, S_local, H, D)."""
    n, me = _size_index(axis)
    b, s_local, h_heads, d = q.shape
    if s_local % 2:
        raise ValueError(f"zigzag needs even local length, got {s_local}")
    half = s_local // 2
    scale_ = 1.0 / math.sqrt(d) if scale is None else scale
    q_t = q.transpose(1, 2)  # (B, H, S, D)

    def flash_update(m, l, acc, sc, v_blk, row0):
        """The online-softmax update of rows [row0, row0 + rows)."""
        rows = sc.shape[2]
        sl = slice(row0, row0 + rows)
        m_h, l_h, a_h = m[:, :, sl], l[:, :, sl], acc[:, :, sl]
        m_new = torch.maximum(m_h, sc.amax(dim=-1))
        alpha = torch.exp(m_h - m_new)
        p = torch.exp(sc - m_new[..., None])
        l_h = l_h * alpha + p.sum(dim=-1)
        a_h = a_h * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk)
        # out of place, as JAX's dynamic_update_slice: autograd keeps every step
        return (torch.cat([m[:, :, :row0], m_new, m[:, :, row0 + rows:]], 2),
                torch.cat([l[:, :, :row0], l_h, l[:, :, row0 + rows:]], 2),
                torch.cat([acc[:, :, :row0], a_h, acc[:, :, row0 + rows:]], 2))

    m = torch.full((b, h_heads, s_local), NEG_BIG, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h_heads, s_local), dtype=q.dtype, device=q.device)
    acc = torch.zeros((b, h_heads, s_local, d), dtype=q.dtype, device=q.device)

    ar = torch.arange(half, device=q.device)
    tri = ar[:, None] >= ar[None, :]
    sc_ll = torch.einsum("bhqd,bkhd->bhqk", q_t[:, :, :half], k[:, :half]) * scale_
    sc_ll = sc_ll.masked_fill(~tri, NEG_BIG)
    m, l, acc = flash_update(m, l, acc, sc_ll, v[:, :half], 0)
    sc_hl = torch.einsum("bhqd,bkhd->bhqk", q_t[:, :, half:], k[:, :half]) * scale_
    m, l, acc = flash_update(m, l, acc, sc_hl, v[:, :half], half)
    sc_hh = torch.einsum("bhqd,bkhd->bhqk", q_t[:, :, half:], k[:, half:]) * scale_
    sc_hh = sc_hh.masked_fill(~tri, NEG_BIG)
    m, l, acc = flash_update(m, l, acc, sc_hh, v[:, half:], half)

    perm = _ring_perm(n)
    k_blk, v_blk = k, v
    for t in range(1, n):
        k_blk = ppermute(k_blk, perm, axis)
        v_blk = ppermute(v_blk, perm, axis)
        src = (me - t) % n
        early = src < me  # chunk indices decide causality, not ring distance
        # product 1: rows = early ? q_lo : q_hi; cols = k_lo
        q1 = 0 if early else half
        sc1 = torch.einsum("bhqd,bkhd->bhqk", q_t[:, :, q1:q1 + half], k_blk[:, :half]) * scale_
        m, l, acc = flash_update(m, l, acc, sc1, v_blk[:, :half], q1)
        # product 2: rows = q_hi; cols = early ? k_lo : k_hi
        k2 = 0 if early else half
        sc2 = (torch.einsum("bhqd,bkhd->bhqk", q_t[:, :, half:], k_blk[:, k2:k2 + half])
               * scale_)
        m, l, acc = flash_update(m, l, acc, sc2, v_blk[:, k2:k2 + half], half)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


def ulysses_attention(q, k, v, axis=None, *, causal: bool = False, scale=None):
    """Sequence -> head all-to-all attention (the DeepSpeed-Ulysses
    pattern): the head count must divide by the axis size n. Each rank
    trades its sequence shard of all heads for the whole sequence of H/n
    heads, attends locally, and trades back."""
    n, _ = _size_index(axis)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"ulysses needs heads ({h}) divisible by axis size ({n})")
    qf, kf, vf = (all_to_all(x, 2, 1, axis) for x in (q, k, v))  # (B, S, H/n, D)
    out = attention(qf, kf, vf, causal=causal, scale=scale)
    return all_to_all(out, 1, 2, axis)
