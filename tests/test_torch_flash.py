"""The port's flash attention (`ops/flash_attention.py`, `ops/flash.py`)
against the JAX package's `flash_mha`, run as its own tests run it on the
CPU (Pallas in interpret mode), on the same numpy inputs.

On the CPU the port's wrappers run the kernels' plain versions; the CUDA
kernels themselves are held against those plain versions on the card
(the `cuda` tests here, skipped without one, and `chip_smoke.py` phase 12).

Tolerances: f32 outputs and gradients atol = rtol = 2e-5 (two float stacks
summing in other orders; the JAX package's own flash test uses the same);
bf16 outputs 1e-2 (one bf16 ulp at 1 is 2^-7); the quantized forward 2e-5
against JAX at the same k tile (the codes are the same; only f32 sums differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.ops.flash_pallas import FlashBlocks, _fwd_call
from distributed_neural_network_tpu.ops.flash_pallas import flash_mha as jax_flash_mha
from distributed_neural_network_tpu.ops.quant import quantized_attention as jax_quant_attn
from distributed_neural_network_tpu.parallel.ring import attention as jax_attention
from distributed_neural_network_tpu_torch.ops import flash_attention as fa
from distributed_neural_network_tpu_torch.ops.flash import flash_local_attention
from distributed_neural_network_tpu_torch.ops.quant import quantized_attention
from distributed_neural_network_tpu_torch.parallel.ring import attention

F32_TOL = 2e-5


def _qkv(b=2, s=40, h=2, d=16, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, s, h, d)) * 0.5).astype(np.float32) for _ in range(n)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_k", [fa.BLOCK_K, 16])
def test_plain_forward_matches_jax(n_devices, causal, dtype, block_k):
    """o and lse of the plain forward at S = 40 (not a multiple of the
    port's tile; block_k 16 leaves a ragged last tile) against JAX
    flash_mha in interpret mode and both packages' plain attention."""
    q, k, v = _qkv()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = _np(jax_flash_mha(jq, jk, jv, causal=causal, interpret=True))
    o, lse = fa.flash_fwd_plain(*(_t(x, tdt) for x in (q, k, v)), causal=causal,
                                block_k=block_k)
    assert o.dtype == tdt and tuple(o.shape) == q.shape and tuple(lse.shape) == (2, 2, 40)
    tol = F32_TOL if dtype == "float32" else 1e-2
    np.testing.assert_allclose(o.float().numpy(), want, atol=tol, rtol=tol)
    ref = _np(jax_attention(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(o.float().numpy(), ref, atol=tol, rtol=tol)
    ours = attention(*(_t(x, tdt) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol, rtol=tol)
    # lse against the Pallas forward's own residual
    b, s, h, d = q.shape
    flat = [jnp.asarray(x, jdt).transpose(0, 2, 1, 3).reshape(b * h, s, d) for x in (q, k, v)]
    _, jlse = _fwd_call(*flat, blocks=FlashBlocks().resolve(s), scale=1 / np.sqrt(d),
                        causal=causal, interpret=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(b, h, s), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_grads_match_jax(n_devices, causal):
    """dq/dk/dv through the port's autograd Function (plain route) against
    jax.grad of flash_mha in interpret mode, through sum(o * w)."""
    q, k, v, w = _qkv(s=24, seed=1, n=4)

    def jloss(a, b_, c):
        return jnp.sum(jax_flash_mha(a, b_, c, causal=causal, interpret=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_mha(*leaves, causal=causal) * _t(w)).sum().backward()
    for got, exp in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp), atol=F32_TOL, rtol=F32_TOL)
    assert not any(fa.LAUNCHES.values())  # the CPU route launches nothing


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("causal", [True, False])
def test_quant_plain_matches_jax_at_the_same_k_tile(n_devices, fmt, causal):
    """The quantized plain forward at block_k = 8 against the JAX quantized
    kernel at bk = 8 (S = 32, a multiple of it), and at the port's own tile
    (>= S, one tile per row) against both quantized_attention references."""
    q, k, v = _qkv(s=32, seed=2)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (_t(x) for x in (q, k, v))
    codes = fa.quantize_qkv(tq, tk, tv, fmt)
    qc, sq, kc, sk, vc, sv = codes
    want = _np(jax_flash_mha(jq, jk, jv, causal=causal, quant=fmt, interpret=True,
                             blocks=FlashBlocks(bq=16, bk=8)))
    got, _ = fa.flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv, causal=causal, block_k=8)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    whole, _ = fa.flash_fwd_quant(tq, tk, tv, fmt=fmt, causal=causal)
    ref = _np(jax_quant_attn(jq, jk, jv, causal=causal, fmt=fmt))
    np.testing.assert_allclose(whole.numpy(), ref, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(quantized_attention(tq, tk, tv, causal=causal, fmt=fmt).numpy(),
                               ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_straight_through_grads_match_jax(n_devices, fmt):
    """A quantized forward's gradients are the full-precision backward on
    the original q/k/v at the quantized forward's o and lse, in both
    packages (S = 32 <= both k tiles, so the forwards agree)."""
    q, k, v, w = _qkv(s=32, seed=3, n=4)

    def jloss(a, b_, c):
        o = jax_flash_mha(a, b_, c, causal=True, quant=fmt, interpret=True,
                          blocks=FlashBlocks(bq=32, bk=32))
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_mha(*leaves, quant=fmt) * _t(w)).sum().backward()
    for got, exp in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp), atol=F32_TOL, rtol=F32_TOL)


def test_plain_backward_pieces_agree():
    """flash_bwd_plain equals autograd of the plain attention, and the
    wrappers' CPU route equals the plain versions bit for bit."""
    q, k, v, do = (_t(x) for x in _qkv(s=20, seed=4, n=4))
    o, lse = fa.flash_fwd(q, k, v)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in
               zip((dq, dk, dv), fa.flash_bwd_plain(q, k, v, o, lse, do)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(attention(*leaves, causal=True), do)
    for got, ref in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, ref.grad, atol=F32_TOL, rtol=F32_TOL)


def test_dispatch_routes_and_checks(monkeypatch):
    # no environment variable chooses the route: only impl="lib" does
    monkeypatch.setenv("DNN_TPU_FLASH_IMPL", "pallas")
    q, k, v = (_t(x) for x in _qkv(s=12, seed=5))
    ref = attention(q, k, v, causal=True)
    torch.testing.assert_close(flash_local_attention(q, k, v), ref, atol=F32_TOL, rtol=F32_TOL)
    lib = flash_local_attention(q, k, v, impl="lib")
    torch.testing.assert_close(lib, ref, atol=F32_TOL, rtol=F32_TOL)
    with pytest.raises(ValueError, match="no quantized path"):
        flash_local_attention(q, k, v, impl="lib", quant="int8")
    with pytest.raises(ValueError, match="unknown flash impl"):
        flash_local_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="unknown quant"):
        fa.flash_mha(q, k, v, quant="int4")
    with pytest.raises(ValueError, match="D <= 128"):
        fa.flash_fwd(*(torch.zeros(1, 4, 1, 129) for _ in range(3)))
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_fwd(q, k[:, :6], v)
    with pytest.raises(TypeError, match="must be one of"):
        fa.flash_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_fwd(q.transpose(1, 3), k.transpose(1, 3), v.transpose(1, 3))
    # a strided (B, S, H, D) view is legal and gives the contiguous answer
    o_view, _ = fa.flash_fwd(*(x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)))
    assert torch.equal(o_view, fa.flash_fwd(q, k, v)[0])


def _bf16(shape, offset=0, pad=0):
    """A bf16 (B, S, H, D) tensor: head dims `offset` .. `offset` + D of a
    buffer whose last axis is D + `pad` long (a view that starts `offset`
    elements past its buffer's base, with strides of D + `pad`)."""
    b, s, h, d = shape
    buf = torch.randn(b, s, h, d + pad, generator=torch.Generator().manual_seed(0))
    return buf.to(torch.bfloat16)[..., offset:offset + d]


def _aligned(t):
    return t.data_ptr() % fa.MMA_ALIGN_BYTES == 0


# (case, the four inputs' builder, the route when every base is 16-byte aligned)
ROUTE_CASES = [
    ("bf16 D64", lambda: [_bf16((2, 40, 2, 64)) for _ in range(4)], "mma"),
    ("bf16 D16", lambda: [_bf16((1, 9, 3, 16)) for _ in range(4)], "mma"),
    ("bf16 D32", lambda: [_bf16((2, 7, 2, 32)) for _ in range(4)], "mma"),
    ("bf16 D48", lambda: [_bf16((1, 5, 2, 48)) for _ in range(4)], "mma"),
    ("bf16 D128", lambda: [_bf16((1, 5, 2, 128)) for _ in range(4)], "mma"),
    ("bf16 D40", lambda: [_bf16((2, 7, 2, 40)) for _ in range(4)], "simt"),
    ("bf16 D8", lambda: [_bf16((2, 7, 2, 8)) for _ in range(4)], "simt"),
    ("bf16 D24", lambda: [_bf16((2, 7, 2, 24)) for _ in range(4)], "simt"),
    ("f32 D64", lambda: [torch.zeros(2, 7, 2, 64) for _ in range(4)], "simt"),
    ("bf16 strided (B, H, S, D) buffer",
     lambda: [_bf16((2, 3, 5, 64)).permute(0, 2, 1, 3) for _ in range(4)], "mma"),
    ("bf16 strided D16", lambda: [_bf16((1, 2, 9, 16)).transpose(1, 2) for _ in range(4)], "mma"),
    ("bf16 view 8 elements in (16 bytes)", lambda: [_bf16((2, 7, 2, 64), 8, 16) for _ in range(4)],
     "mma"),
    ("bf16 view 4 elements in (8 bytes)", lambda: [_bf16((2, 7, 2, 64), 4, 8) for _ in range(4)],
     "simt"),
    ("bf16 dO alone misaligned",
     lambda: [_bf16((2, 7, 2, 64)) for _ in range(3)] + [_bf16((2, 7, 2, 64), 4, 8)], "simt"),
    ("bf16 head stride D + 4", lambda: [_bf16((2, 7, 2, 64), 0, 4) for _ in range(4)], "simt"),
    ("bf16 k's head stride D + 4",
     lambda: [_bf16((2, 7, 2, 64)), _bf16((2, 7, 2, 64), 0, 4)] + [_bf16((2, 7, 2, 64))] * 2,
     "simt"),
]


@pytest.mark.parametrize("name, make, route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_bwd_route_rule(name, make, route):
    """The backward's route from dtype, head dim, alignment and strides. A
    CPU buffer's base is aligned by its allocator, not by this test, so the
    expected route takes the base pointers as they came: a case meant for
    the mma route goes to simt when an allocator hands out a base off a
    16-byte boundary."""
    q, k, v, do = make()
    want = route if route == "simt" or all(_aligned(t) for t in (q, k, v, do)) else "simt"
    assert fa.bwd_route(q, k, v, do) == want
    # the rule reads nothing but the four inputs' metadata: copies of the
    # same values in contiguous aligned buffers route by dtype and D alone
    copies = [t.contiguous() for t in (q, k, v, do)]
    legal_d = q.shape[-1] % fa.MMA_DIM_STEP == 0 and q.dtype == torch.bfloat16
    if all(_aligned(t) for t in copies):
        assert fa.bwd_route(*copies) == ("mma" if legal_d else "simt")


@pytest.mark.parametrize("name, make, route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_bwd_launch_takes_the_routes_entry_and_counts_it(monkeypatch, name, make, route):
    """On the card the wrapper launches the entry point of the route the
    rule picks and counts it in LAUNCHES and ROUTE_LAUNCHES; here the
    launch is recorded instead of made (CPU tensors, no nvcc)."""
    q, k, v, do = make()
    calls = []
    monkeypatch.setattr(fa, "_lib", lambda: None)
    monkeypatch.setattr(fa._nvcc, "launch", lambda lib, entry, device, *args: calls.append(
        (entry, args)))
    monkeypatch.setattr(fa, "LAUNCHES", dict.fromkeys(fa.LAUNCHES, 0))
    monkeypatch.setattr(fa, "ROUTE_LAUNCHES", dict.fromkeys(fa.ROUTE_LAUNCHES, 0))
    b, s, h, d = q.shape
    lse = delta = torch.zeros(b, h, s)
    dq = torch.empty(q.shape, dtype=q.dtype)
    dk, dv = torch.empty(q.shape, dtype=q.dtype), torch.empty(q.shape, dtype=q.dtype)
    fa._launch_bwd("flash_dq", q, k, v, do, lse, delta, (dq,), None, True)
    fa._launch_bwd("flash_dkv", q, k, v, do, lse, delta, (dk, dv), None, True)
    got = fa.bwd_route(q, k, v, do)
    suffix = "_mma" if got == "mma" else ""
    assert [c[0] for c in calls] == ["flash_dq" + suffix, "flash_dkv" + suffix]
    # dtype code, 4 input views, lse, delta, the outputs' views, the shape
    assert [len(c[1]) for c in calls] == [1 + 16 + 2 + 4 + 6, 1 + 16 + 2 + 8 + 6]
    assert calls[0][1][0] == fa._DTYPE_CODE[q.dtype] and calls[0][1][1] == q.data_ptr()
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_fwd_quant": 0, "flash_dq": 1, "flash_dkv": 1}
    assert fa.ROUTE_LAUNCHES == {f"{kern}_{r}": int(r == got and kern in ("flash_dq", "flash_dkv"))
                                 for kern in fa.ROUTED for r in fa.ROUTES}


# the forward reads no dO: a case whose only misaligned input is dO runs
# its forward on the mma route
FWD_ROUTE = {"bf16 dO alone misaligned": "mma"}


@pytest.mark.parametrize("name, make, route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_fwd_route_rule(name, make, route):
    """The forward's route from q, k, v's dtype, head dim, alignment and
    strides, by the backward's rule (base pointers taken as they came, as in
    test_bwd_route_rule)."""
    q, k, v, _ = make()
    route = FWD_ROUTE.get(name, route)
    want = route if route == "simt" or all(_aligned(t) for t in (q, k, v)) else "simt"
    assert fa.fwd_route(q, k, v) == want


@pytest.mark.parametrize("name, make, route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_fwd_and_bwd_routes_agree(name, make, route):
    """One rule: the forward's route on (q, k, v) is the backward's on (q,
    k, v) with q in dO's place, and a backward on the mma route has its
    forward there too."""
    q, k, v, do = make()
    assert fa.fwd_route(q, k, v) == fa.bwd_route(q, k, v, q)
    if fa.bwd_route(q, k, v, do) == "mma":
        assert fa.fwd_route(q, k, v) == "mma"


@pytest.mark.parametrize("name, make, route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_fwd_launch_takes_the_routes_entry_and_counts_it(monkeypatch, name, make, route):
    """On the card the forward launches the entry point of the route the
    rule picks and counts it in LAUNCHES and ROUTE_LAUNCHES; here the
    launch is recorded instead of made."""
    q, k, v, _ = make()
    calls = []
    monkeypatch.setattr(fa, "_lib", lambda: None)
    monkeypatch.setattr(fa._nvcc, "launch", lambda lib, entry, device, *args: calls.append(
        (entry, args)))
    monkeypatch.setattr(fa, "LAUNCHES", dict.fromkeys(fa.LAUNCHES, 0))
    monkeypatch.setattr(fa, "ROUTE_LAUNCHES", dict.fromkeys(fa.ROUTE_LAUNCHES, 0))
    b, s, h, d = q.shape
    o, lse = torch.empty(q.shape, dtype=q.dtype), torch.zeros(b, h, s)
    fa._launch_fwd(q, k, v, o, lse, None, True)
    got = fa.fwd_route(q, k, v)
    (entry, args), = calls
    # dtype code, 4 views (q, k, v, o), lse, the shape
    assert entry == ("flash_fwd_mma" if got == "mma" else "flash_fwd")
    assert len(args) == 1 + 16 + 1 + 6
    assert args[0] == fa._DTYPE_CODE[q.dtype] and args[1] == q.data_ptr()
    assert args[13] == o.data_ptr() and args[17] == lse.data_ptr()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_fwd_quant": 0, "flash_dq": 0, "flash_dkv": 0}
    assert fa.ROUTE_LAUNCHES == {f"{kern}_{r}": int(kern == "flash_fwd" and r == got)
                                 for kern in fa.ROUTED for r in fa.ROUTES}


def test_route_counters_sum_to_the_totals_and_stay_zero_on_the_cpu():
    """Every kernel has a route counter per route (their sums are the
    LAUNCHES totals), and the CPU route counts nothing: the plain versions
    run instead of the kernels."""
    assert set(fa.ROUTE_LAUNCHES) == {f"{k}_{r}" for k in ("flash_fwd", "flash_fwd_quant",
                                                           "flash_dq", "flash_dkv")
                                      for r in fa.ROUTES}
    assert set(fa.ROUTED) == set(fa.LAUNCHES)
    for kern in fa.LAUNCHES:
        assert fa.LAUNCHES[kern] == sum(fa.ROUTE_LAUNCHES[f"{kern}_{r}"] for r in fa.ROUTES)
    q, k, v, do = (_bf16((1, 20, 2, 64)) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    fa.flash_bwd(q, k, v, o, lse, do)
    fa.flash_fwd_quant(q, k, v, fmt="int8")
    fa.flash_fwd_quant(q, k, v, fmt="fp8")
    assert not any(fa.ROUTE_LAUNCHES.values()) and not any(fa.LAUNCHES.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d, strided, route", [
    (torch.float32, 64, False, "simt"), (torch.bfloat16, 64, False, "mma"),
    (torch.bfloat16, 64, True, "mma"), (torch.bfloat16, 128, True, "mma")])
def test_card_kernels_match_plain(cuda_device, dtype, d, strided, route):
    """On the card: each kernel against its plain version at a ragged S,
    the forward and the backward on the route the rule gives (bf16 strided
    views of a (B, H, S, D) buffer: the tensor-core kernels)."""
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    arrays = _qkv(s=100, h=3, d=d, n=4)
    if strided:
        arrays = [np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in arrays]
    q, k, v, do = (_t(x, dtype).to(cuda_device) for x in arrays)
    if strided:
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    assert fa.bwd_route(q, k, v, do) == fa.fwd_route(q, k, v) == route
    before = dict(fa.ROUTE_LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    delta = fa.flash_delta(o, do)
    for got, ref in zip((fa.flash_dq(q, k, v, do, lse, delta),
                         *fa.flash_dkv(q, k, v, do, lse, delta)),
                        (fa.flash_dq_plain(q, k, v, do, lse, delta),
                         *fa.flash_dkv_plain(q, k, v, do, lse, delta))):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    assert {key: n - before[key] for key, n in fa.ROUTE_LAUNCHES.items()} == {
        f"{kern}_{r}": int(r == route) for kern in fa.ROUTED for r in fa.ROUTES}


# ------------------------------------------------- the quantized forward's route


def _codes(shape, dtype=torch.int8, offset=0, pad=0, transpose=False):
    """8-bit codes (B, S, H, D): head dims `offset` .. `offset` + D of a
    buffer whose last axis is D + `pad` long, of a (B, H, S, D + pad) buffer
    read as (B, S, H, D) when `transpose`."""
    b, s, h, d = shape
    if transpose:
        buf = torch.zeros(b, h, s, d + pad, dtype=torch.int8)
        return buf.view(dtype)[..., offset:offset + d].transpose(1, 2)
    return torch.zeros(b, s, h, d + pad, dtype=torch.int8).view(dtype)[..., offset:offset + d]


E4M3 = torch.float8_e4m3fn
# (case, a builder of (qc, kc, vc), the route when every base is 16-byte aligned)
QUANT_ROUTE_CASES = [
    ("int8 D64", lambda: [_codes((2, 40, 2, 64)) for _ in "qkv"], "mma"),
    ("e4m3 D64", lambda: [_codes((2, 40, 2, 64), E4M3) for _ in "qkv"], "mma"),
    ("int8 D16", lambda: [_codes((1, 9, 3, 16)) for _ in "qkv"], "mma"),
    ("e4m3 D48", lambda: [_codes((1, 9, 3, 48), E4M3) for _ in "qkv"], "mma"),
    ("int8 D128", lambda: [_codes((1, 5, 2, 128)) for _ in "qkv"], "mma"),
    ("int8 D8", lambda: [_codes((2, 7, 2, 8)) for _ in "qkv"], "simt"),
    ("e4m3 D40", lambda: [_codes((2, 7, 2, 40), E4M3) for _ in "qkv"], "simt"),
    ("int8 strided (B, H, S, D) buffer",
     lambda: [_codes((2, 5, 3, 64), transpose=True) for _ in "qkv"], "mma"),
    ("int8 view 16 bytes in", lambda: [_codes((2, 7, 2, 64), offset=16, pad=32) for _ in "qkv"],
     "mma"),
    ("int8 view 8 bytes in", lambda: [_codes((2, 7, 2, 64), offset=8, pad=16) for _ in "qkv"],
     "simt"),
    ("e4m3 v alone 8 bytes in",
     lambda: [_codes((2, 7, 2, 64), E4M3) for _ in "qk"]
     + [_codes((2, 7, 2, 64), E4M3, offset=8, pad=16)], "simt"),
    ("int8 head stride D + 8", lambda: [_codes((2, 7, 2, 64), pad=8) for _ in "qkv"], "simt"),
    ("bf16 (not codes)", lambda: [_bf16((2, 7, 2, 64)) for _ in "qkv"], "simt"),
]


@pytest.mark.parametrize("name, make, route", QUANT_ROUTE_CASES,
                         ids=[c[0] for c in QUANT_ROUTE_CASES])
def test_quant_route_rule(name, make, route):
    """The quantized forward's route from the codes' dtype, head dim,
    alignment and strides (base pointers taken as the allocator gave them,
    as in test_bwd_route_rule); contiguous aligned copies of 8-bit codes
    route by D alone."""
    qc, kc, vc = make()
    want = route if route == "simt" or all(_aligned(t) for t in (qc, kc, vc)) else "simt"
    assert fa.quant_route(qc, kc, vc) == want
    copies = [t.contiguous() for t in (qc, kc, vc)]
    if all(_aligned(t) for t in copies) and qc.element_size() == 1:
        assert fa.quant_route(*copies) == ("mma" if qc.shape[-1] % 16 == 0 else "simt")


@pytest.mark.parametrize("name, make, route", QUANT_ROUTE_CASES[:-1],
                         ids=[c[0] for c in QUANT_ROUTE_CASES[:-1]])
def test_quant_launch_takes_the_routes_entry_and_counts_it(monkeypatch, name, make, route):
    """On the card the quantized forward launches the entry point of the
    route `quant_route` picks and counts it in LAUNCHES and ROUTE_LAUNCHES;
    here the launch is recorded instead of made (CPU tensors, no nvcc)."""
    qc, kc, vc = make()
    calls = []
    monkeypatch.setattr(fa, "_lib", lambda: None)
    monkeypatch.setattr(fa._nvcc, "launch", lambda lib, entry, device, *args: calls.append(
        (entry, args)))
    monkeypatch.setattr(fa, "LAUNCHES", dict.fromkeys(fa.LAUNCHES, 0))
    monkeypatch.setattr(fa, "ROUTE_LAUNCHES", dict.fromkeys(fa.ROUTE_LAUNCHES, 0))
    b, s, h, _ = qc.shape
    sq, sk, sv = (torch.ones(b, s, h) for _ in "qkv")
    o, lse = torch.empty(qc.shape, dtype=torch.bfloat16), torch.zeros(b, h, s)
    fa._launch_quant(qc, kc, vc, sq, sk, sv, o, lse, None, True)
    got = fa.quant_route(qc, kc, vc)
    (entry, args), = calls
    assert entry == ("flash_fwd_quant_mma" if got == "mma" else "flash_fwd_quant")
    # o's dtype code, the format, 7 views (codes, scales, o), lse, the shape
    assert len(args) == 2 + 28 + 1 + 6
    assert args[:3] == (fa._DTYPE_CODE[torch.bfloat16], int(qc.dtype == E4M3), qc.data_ptr())
    assert fa.LAUNCHES == {k: int(k == "flash_fwd_quant") for k in fa.LAUNCHES}
    assert fa.ROUTE_LAUNCHES == {k: int(k == f"flash_fwd_quant_{got}") for k in fa.ROUTE_LAUNCHES}


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("causal", [True, False])
def test_quant_plain_matches_jax_at_the_kernels_k_tile(n_devices, fmt, causal):
    """The quantized plain version at the kernels' own k tile (BLOCK_K = 64)
    against the JAX quantized Pallas kernel (`_fwd_quant_kernel`, interpret
    mode) at bk = 64, over S = 128 (two k tiles, so p's per-tile scales
    differ from one per row), at F32_TOL: the codes are the same, only f32
    sums differ."""
    q, k, v = _qkv(s=128, seed=6)
    tq, tk, tv = (_t(x) for x in (q, k, v))
    qc, sq, kc, sk, vc, sv = fa.quantize_qkv(tq, tk, tv, fmt)
    want = _np(jax_flash_mha(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, quant=fmt,
                             interpret=True, blocks=FlashBlocks(bq=64, bk=fa.BLOCK_K)))
    got, _ = fa.flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_card_quant_routes_match_plain(cuda_device, fmt):
    """On the card: the quantized forward on both routes (aligned codes:
    mma; the same codes 8 bytes off a 16-byte boundary: simt) against its
    plain version, int8 at atol = rtol = 2e-2, fp8 on the mean error (an
    e4m3 code of p may round the other way where expf and torch.exp differ:
    chip_smoke.py FP8_STEP)."""
    q, k, v = (_t(x, torch.bfloat16).to(cuda_device) for x in _qkv(s=200, h=3, d=64))
    codes = fa.quantize_qkv(q, k, v, fmt)
    qc, sq, kc, sk, vc, sv = codes
    mis = []
    for t in (qc, kc, vc):
        buf = torch.zeros(*t.shape[:-1], t.shape[-1] + 16, dtype=torch.int8, device=cuda_device)
        view = buf.view(t.dtype)[..., 8:8 + t.shape[-1]]
        view.copy_(t)
        mis.append(view)
    assert fa.quant_route(qc, kc, vc) == "mma" and fa.quant_route(*mis) == "simt"
    ref, lse_ref = fa.flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv, out_dtype=torch.bfloat16)
    for codes_ in ((qc, kc, vc), mis):
        o, lse = fa.flash_fwd_quant_codes(*codes_, sq, sk, sv, out_dtype=torch.bfloat16)
        diff = (o.float() - ref.float()).abs()
        if fmt == "int8":
            assert torch.allclose(o.float(), ref.float(), atol=2e-2, rtol=2e-2)
        else:
            assert float(diff.mean()) <= 1e-4
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
