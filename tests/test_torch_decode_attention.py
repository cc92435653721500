"""The port's decode attention (`ops/decode_attention.py`) against the JAX
package's Pallas decode kernel (`ops/decode_pallas.py`
`decode_cache_attention`), run in interpret mode as tests/test_decode_pallas.py
runs it, and against the XLA chain that test holds the kernel to.

On CPU tensors the port's wrapper computes the plain PyTorch version; the
CUDA kernels themselves are held against it on the card by chip_smoke.py.
The same numpy inputs feed both frameworks. Tolerances: f32 atol = rtol =
1e-5 (the kernels reassociate the softmax blockwise); bf16 2e-2 (the JAX
kernel rounds p after a block-wise max, the plain version after the row max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.ops.decode_pallas import (
    decode_cache_attention as jax_decode,
)
from distributed_neural_network_tpu_torch.models.transformer import resolve_decode_impl
from distributed_neural_network_tpu_torch.ops import decode_attention as da

B, H, TOTAL, D = 2, 2, 128, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, H, D), (B, H, TOTAL, D), (B, H, TOTAL, D))]


def _xla_chain(q, ck, cv, pos):
    """tests/test_decode_pallas.py's oracle, per-sequence positions."""
    s = jnp.einsum("bhd,bhsd->bhs", q, ck).astype(jnp.float32) / np.sqrt(q.shape[-1])
    live = (jnp.arange(ck.shape[2])[None, :] <= jnp.asarray(pos).reshape(-1, 1))[:, None, :]
    p = jax.nn.softmax(jnp.where(live, s, -1e30), axis=-1)
    return jnp.einsum("bhs,bhsd->bhd", p.astype(cv.dtype), cv)


def _pos_pair(pos):
    """(jax pos, torch pos) for a scalar or a per-sequence list."""
    if isinstance(pos, int):
        return pos, pos
    return jnp.asarray(pos, jnp.int32), torch.tensor(pos, dtype=torch.int32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("pos", [0, 7, TOTAL - 1, [0, TOTAL - 1], [37, 5]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_xla_chain(n_devices, dtype, pos):
    q, ck, cv = _inputs(3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpos, tpos = _pos_pair(pos)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, ck, cv))
    want_kernel = jax_decode(jq, jk, jv, jpos, interpret=True)
    want_chain = _xla_chain(jq, jk, jv, jpos)
    got = da.decode_cache_attention(*(torch.from_numpy(a).to(tdt) for a in (q, ck, cv)), tpos)
    assert got.dtype == tdt and tuple(got.shape) == (B, H, D)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got.float(), want_kernel, tol)
    _close(got.float(), want_chain, tol)


@pytest.mark.parametrize("pos", [0, TOTAL - 1, [0, TOTAL - 1]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_jax_kernel(n_devices, dtype, pos):
    """int8 K/V with per-slot scales: dequantize (rounded to q's dtype), then
    attend, as `_decode_kernel_q8` does inside its k loop."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    ck, cv = (rng.integers(-127, 128, size=(B, H, TOTAL, D)).astype(np.int8) for _ in "kv")
    ks, vs = (rng.uniform(0.001, 0.03, size=(B, H, TOTAL)).astype(np.float32) for _ in "kv")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpos, tpos = _pos_pair(pos)
    want = jax_decode(jnp.asarray(q, jdt), jnp.asarray(ck), jnp.asarray(cv), jpos,
                      k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
    got = da.decode_cache_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(ck), torch.from_numpy(cv), tpos,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    _close(got.float(), want, 1e-5 if dtype == "float32" else 2e-2)


def test_transposed_views_and_padding_give_the_same_result():
    """The engine passes its gathered (B, S, H, Dh) slab as a transposed view,
    and a cache padded to another length must not change the live result
    (1e-6: the plain version's matmuls may sum in another order; the
    kernel's bits are checked on the card)."""
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(5))
    pos = torch.tensor([3, 90])
    want = da.decode_cache_attention(q, ck, cv, pos)
    kt = ck.transpose(1, 2).contiguous().transpose(1, 2)
    vt = cv.transpose(1, 2).contiguous().transpose(1, 2)
    assert not kt.is_contiguous()
    torch.testing.assert_close(da.decode_cache_attention(q, kt, vt, pos), want,
                               rtol=1e-6, atol=1e-6)
    pad = torch.randn(B, H, 64, D)
    got = da.decode_cache_attention(q, torch.cat([ck, pad], 2), torch.cat([cv, pad], 2), pos)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_pos_zero_is_first_slot_only():
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(6))
    got = da.decode_cache_attention(q, ck, cv * 100.0, 0)
    torch.testing.assert_close(got, cv[:, :, 0] * 100.0, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "shape", "missing_scale", "kv_dtype",
                                 "head_dim", "pos_shape", "q_strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(7))
    kw, pos = {}, 0
    if bad == "dtype":
        q, ck, cv = q.double(), ck.double(), cv.double()
    elif bad == "shape":
        q = q[:, :1]
    elif bad == "missing_scale":
        ck, cv = ck.to(torch.int8), cv.to(torch.int8)
        kw = {"k_scale": torch.ones(B, H, TOTAL)}
    elif bad == "kv_dtype":
        ck = ck.bfloat16()
    elif bad == "head_dim":
        q, ck, cv = torch.zeros(B, H, 300), torch.zeros(B, H, 4, 300), torch.zeros(B, H, 4, 300)
    elif bad == "pos_shape":
        pos = torch.zeros(3, dtype=torch.int32)
    else:
        q = torch.zeros(B, D, H).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        da.decode_cache_attention(q, ck, cv, pos, **kw)


def test_legality_rule_and_routes():
    """The port's rule admits the repo's head dims (8, 16, 64, 128) at any
    cache length; `cuda` on a CPU device raises instead of running the plain
    version, `auto` picks the plain version on the CPU."""
    assert all(da.decode_kernel_ok(d) for d in (8, 16, 64, 128))
    assert not da.decode_kernel_ok(0) and not da.decode_kernel_ok(da.MAX_HEAD_DIM + 1)
    cpu = torch.device("cpu")
    assert resolve_decode_impl("auto", cpu) == "torch"
    assert resolve_decode_impl("torch", cpu) == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        resolve_decode_impl("cuda", cpu)
    with pytest.raises(ValueError):
        resolve_decode_impl("pallas", cpu)


def test_module_import_builds_nothing():
    assert da._lib.cache_info().currsize == 0
    assert da.LAUNCHES == {"decode_attention": 0, "decode_attention_q8": 0}
