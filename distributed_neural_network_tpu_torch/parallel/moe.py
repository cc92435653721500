"""Expert parallelism: the port of the JAX package's `parallel/moe.py`, the
mixture-of-experts dispatch and combine in the GShard / Switch style.

- **Static shapes.** Routing gives every expert a fixed *capacity* of slots
  (`expert_capacity`); a token past its expert's capacity is dropped (its
  FFN contribution is zero and the residual stream carries it). Nothing
  reads the host inside the routing (no ``.item()``, ``nonzero`` or boolean
  indexing), so a step that routes is captured as one CUDA graph.
- **Two dispatch forms, one contract.** ``dispatch_impl="dense"`` builds
  the (T, E, C) one-hot dispatch and combine tensors and contracts them
  (`topk_dispatch`, the small-shape oracle, and `generate`'s decode form);
  ``"sort"`` (the default) gives each routed token its (expert, slot)
  coordinate with a round-major one-hot cumsum (`sort_route`, the same
  priority as the dense form), adds the tokens into the (E, C, d) slot
  tensor and gathers the results back. A dropped token's slot is C: the
  slot tensor has a row C+1 that takes it and is cut off, and the gather
  reads it from a zero row, so no index is ever out of range (an
  out-of-range `index_put_` raises on the CPU and device-asserts on CUDA).
- **The router in f32**: ``x.float() @ wr.float()`` and the softmax, as in
  JAX; the port leaves TF32 off (PyTorch's default), so the card routes as
  the JAX reference does. `torch.topk` (``sorted=True``) and `jax.lax.top_k`
  order exact ties differently; the tests' inputs keep every routing margin
  above float noise.
- **Expert parallelism** (``ep_axis``, a `parallel/mesh.py` `Axis`, by
  convention the data axis): each rank routes its own tokens into (E, C, d)
  slots for every expert; `collectives.all_to_all(xe, 0, 1, ep)` makes them
  expert-major (E/n experts' slots from every rank), the local experts run
  as one batched product, and `all_to_all(y, 1, 0, ep)` sends the results
  home. The all-to-all's gradient is the inverse all-to-all, so an expert's
  gradient on its rank holds every source rank's tokens.
- **Tensor parallelism inside the experts** (``tp_axis``): w1/b1 hold this
  rank's hidden columns and w2 its rows; the expert input enters through
  `copy_to_model` and the output is summed by `reduce_from_model` before
  b2 (the JAX ``psum(., "model")`` and its transpose), as the dense MLP.
- **Losses**: the Switch load-balancing loss (E * sum_i f_i P_i over first
  choices) plus ``z_loss_weight`` * mean(logsumexp(logits)^2), the router
  z-loss; the caller weights the sum into its loss.

The expert products are `torch.bmm`: under the named remat policies
(`models/transformer.py` `REMAT_SAVES`) they count as batched dots, as their
JAX `dot_general`s with a batch dimension do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .collectives import all_to_all, copy_to_model, reduce_from_model

DISPATCH_IMPLS = ("sort", "dense")


def expert_capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    """Slots per expert for one rank's `n_tokens` (static)."""
    return max(1, math.ceil(factor * top_k * n_tokens / n_experts))


def _one_hot(idx, n: int, dtype):
    """`jax.nn.one_hot`: a row of zeros for an index outside [0, n) (and,
    unlike `F.one_hot`, no check that reads the device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def topk_dispatch(probs, top_k: int, capacity: int):
    """Greedy top-k routing with per-expert capacity, as (T, E, C) tensors.

    probs: (T, E) router probabilities. Returns (combine, dispatch, aux):
    combine (T, E, C) gate weights, dispatch (T, E, C) 0/1 slot assignment,
    aux the Switch load-balancing loss. A token's slot in its expert is its
    position in token order among that round's choices, after the slots
    earlier rounds filled; the k gates of a token are renormalized over the
    experts it kept."""
    t, e = probs.shape
    dt = probs.dtype
    fill = torch.zeros(e, dtype=torch.int32, device=probs.device)
    masked = probs
    gate_sum = torch.zeros(t, dtype=dt, device=probs.device)
    chosen = []  # per round: (onehot, slot, gate, ok)
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        onehot = _one_hot(idx, e, dt)
        pos = torch.cumsum(onehot, dim=0) - 1.0 + fill[None, :].to(dt)
        pos_tok = (pos * onehot).sum(-1)
        ok = (pos_tok < capacity).to(dt)
        gate = (probs * onehot).sum(-1)
        chosen.append((onehot, pos_tok, gate, ok))
        gate_sum = gate_sum + gate * ok
        fill = fill + (onehot * ok[:, None]).sum(0).to(torch.int32)
        masked = masked - 2.0 * onehot  # no expert twice
    denom = torch.clamp(gate_sum, min=1e-9)
    dispatch = torch.zeros(t, e, capacity, dtype=dt, device=probs.device)
    combine = torch.zeros_like(dispatch)
    for onehot, pos_tok, gate, ok in chosen:
        slot = (onehot[:, :, None] * _one_hot(pos_tok.to(torch.int32), capacity, dt)[:, None, :]
                * ok[:, None, None])
        dispatch = dispatch + slot
        combine = combine + (gate / denom)[:, None, None] * slot
    frac = chosen[0][0].mean(0)
    aux = float(e) * torch.sum(frac * probs.mean(0))
    return combine, dispatch, aux


def sort_route(probs, top_k: int, capacity: int):
    """Coordinate-form top-k routing with per-expert capacity.

    probs: (T, E). Returns (expert_idx, slot_idx, weight, aux), each of the
    first three (k*T,) in round-major order (every first choice in token
    order, then every second: the dense form's priority): the expert, the
    slot in its capacity buffer (== capacity for a dropped token) and the
    combine weight (the kept gates renormalized; 0 when dropped). aux is
    the Switch load-balancing loss. O(T*k*E) work, no (T, E, C) tensor."""
    gates, experts = torch.topk(probs, top_k, dim=-1, sorted=True)  # (T, k), priority order
    return route_coordinates(probs, gates, experts, capacity)


def route_coordinates(probs, gates, experts, capacity: int):
    """`sort_route` from the choices made: `experts` (T, k) in priority
    order and their `gates` (T, k) (`probs` gathered at `experts`, through
    which the gradient flows) -> (expert_idx, slot_idx, weight, aux)."""
    t, e = probs.shape
    top_k = experts.shape[1]
    flat_e = experts.T.reshape(-1)
    flat_g = gates.T.reshape(-1)
    # (E, kT): the running count along the contiguous token axis (a scan
    # down the kT rows of a (kT, E) tensor runs over the E columns only:
    # 11.6 ms a call at kT 65,536 on an H100)
    onehot = _one_hot(flat_e, e, torch.int32).T.contiguous()
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(0)
    keep = pos < capacity
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    kept_g = torch.where(keep, flat_g, torch.zeros_like(flat_g)).reshape(top_k, t)
    denom = torch.clamp(kept_g.sum(0), min=1e-9)
    weight = (kept_g / denom[None, :]).reshape(-1)
    frac = onehot[:, :t].float().mean(1).to(probs.dtype)
    aux = float(e) * torch.sum(frac * probs.mean(0))
    return flat_e, slot, weight, aux


def moe_ffn(x, wr, w1, b1, w2, b2, *, top_k: int = 2, capacity: int, ep_axis=None,
            tp_axis=None, dispatch_impl: str = "sort", z_loss_weight: float = 0.0):
    """Mixture-of-experts gelu FFN on a flat token batch.

    x: (T, d) this rank's tokens. wr: (d, E) router (E the global expert
    count). w1 (E_local, d, F_local), b1 (E_local, F_local), w2 (E_local,
    F_local, d), b2 (E_local, d): this rank's experts (E_local = E/|ep|) and
    hidden columns (F_local = F/|tp|). Returns (y, aux): y (T, d) in x's
    dtype; aux the Switch loss plus ``z_loss_weight`` * mean(lse^2), f32.
    ``dispatch_impl``: "sort" (add and gather by coordinates) or "dense"
    (the one-hot contractions), the same values."""
    if dispatch_impl not in DISPATCH_IMPLS:
        raise ValueError(f"dispatch_impl must be 'sort' or 'dense', got {dispatch_impl!r}")
    dt = x.dtype
    t, d = x.shape
    logits = x.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)
    e = probs.shape[1]
    if dispatch_impl == "dense":
        combine, dispatch, aux = topk_dispatch(probs, top_k, capacity)
        xe = torch.einsum("tec,td->ecd", dispatch.to(dt), x)  # (E, C, d)
    else:
        flat_e, slot, weight, aux = sort_route(probs, top_k, capacity)
        # row (e, capacity) of each expert takes its dropped tokens and is cut off;
        # the kept slots are unique, so each holds its token exactly (0 + x)
        at = flat_e * (capacity + 1) + slot
        xe = x.new_zeros(e * (capacity + 1), d).index_add(0, at, x.repeat(top_k, 1))
        xe = xe.view(e, capacity + 1, d)[:, :capacity]
    xe = all_to_all(xe, 0, 1, ep_axis)  # (E_local, n*C, d)
    h = torch.bmm(copy_to_model(xe, tp_axis), w1.to(dt)) + b1.to(dt)[:, None]
    h = F.gelu(h, approximate="tanh")
    y = reduce_from_model(torch.bmm(h, w2.to(dt)), tp_axis) + b2.to(dt)[:, None]
    y = all_to_all(y, 1, 0, ep_axis)  # (E, C, d)
    if dispatch_impl == "dense":
        out = torch.einsum("tec,ecd->td", combine.to(dt), y)
    else:
        # a dropped token reads the zero row (e, capacity)
        y_pad = torch.cat([y, y.new_zeros(e, 1, d)], dim=1).reshape(-1, d)
        gathered = y_pad.index_select(0, at)
        out = (gathered * weight.to(dt)[:, None]).reshape(top_k, t, d).sum(0)
    if z_loss_weight:
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + float(z_loss_weight) * torch.mean(z * z)
    return out, aux
