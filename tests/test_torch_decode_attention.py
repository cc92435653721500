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

import inspect

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
    assert da.ROUTE_LAUNCHES == {"decode_attention_split": 0, "decode_attention_simt": 0,
                                 "decode_attention_q8_simt": 0}


# ----------------------------------------------------------- the split route


def _view(shape, dtype=torch.bfloat16, offset=0, pad=0, transpose=False):
    """A (B, H, S, Dh) tensor: a view starting `offset` elements into rows
    padded by `pad` elements, of a (B, S, H, Dh + pad) buffer when
    `transpose` (the serving engine's slab) or a (B, H, S, Dh + pad) one."""
    b, h, s, d = shape
    if transpose:
        buf = torch.zeros(b, s, h, d + pad + offset, dtype=dtype)
        return buf[..., offset:offset + d].transpose(1, 2)
    return torch.zeros(b, h, s, d + pad + offset, dtype=dtype)[..., offset:offset + d]


def _q(b, h, d, dtype=torch.bfloat16):
    return torch.zeros(b, h, d, dtype=dtype)


# (case, a function making (q, ck, cv, k_scale), the route when every base is 16-byte aligned)
ROUTE_CASES = [
    ("bf16 Dh64", lambda: (_q(8, 8, 64), _view((8, 8, 32, 64)), _view((8, 8, 32, 64)), None),
     "split"),
    ("bf16 Dh64 engine slab", lambda: (_q(8, 8, 64), _view((8, 8, 32, 64), transpose=True),
                                       _view((8, 8, 32, 64), transpose=True), None), "split"),
    ("bf16 Dh128", lambda: (_q(2, 4, 128), _view((2, 4, 20, 128)), _view((2, 4, 20, 128)),
                            None), "split"),
    ("bf16 Dh8", lambda: (_q(2, 4, 8), _view((2, 4, 20, 8)), _view((2, 4, 20, 8)), None),
     "split"),
    ("bf16 Dh256", lambda: (_q(1, 2, 256), _view((1, 2, 5, 256)), _view((1, 2, 5, 256)), None),
     "split"),
    ("f32 Dh64", lambda: (_q(2, 4, 64, torch.float32), _view((2, 4, 9, 64), torch.float32),
                          _view((2, 4, 9, 64), torch.float32), None), "split"),
    ("f32 Dh4", lambda: (_q(2, 4, 4, torch.float32), _view((2, 4, 9, 4), torch.float32),
                         _view((2, 4, 9, 4), torch.float32), None), "split"),
    ("f32 Dh256", lambda: (_q(1, 1, 256, torch.float32), _view((1, 1, 3, 256), torch.float32),
                           _view((1, 1, 3, 256), torch.float32), None), "split"),
    ("bf16 Dh12 (24 bytes)", lambda: (_q(2, 2, 12), _view((2, 2, 9, 12)), _view((2, 2, 9, 12)),
                                      None), "simt"),
    ("f32 Dh6 (24 bytes)", lambda: (_q(2, 2, 6, torch.float32), _view((2, 2, 9, 6), torch.float32),
                                    _view((2, 2, 9, 6), torch.float32), None), "simt"),
    ("bf16 Dh40", lambda: (_q(2, 2, 40), _view((2, 2, 9, 40)), _view((2, 2, 9, 40)), None),
     "split"),
    ("bf16 K/V 8 bytes in", lambda: (_q(2, 2, 64), _view((2, 2, 9, 64), offset=4, pad=4),
                                     _view((2, 2, 9, 64), offset=4, pad=4), None), "simt"),
    ("bf16 V alone 8 bytes in", lambda: (_q(2, 2, 64), _view((2, 2, 9, 64)),
                                         _view((2, 2, 9, 64), offset=4, pad=4), None), "simt"),
    ("bf16 K/V 16 bytes in", lambda: (_q(2, 2, 64), _view((2, 2, 9, 64), offset=8, pad=8),
                                      _view((2, 2, 9, 64), offset=8, pad=8), None), "split"),
    ("bf16 slot stride Dh + 4", lambda: (_q(2, 2, 64), _view((2, 2, 9, 64), pad=4),
                                         _view((2, 2, 9, 64), pad=4), None), "simt"),
    ("bf16 q 8 bytes in", lambda: (torch.zeros(2 * 2 * 64 + 4, dtype=torch.bfloat16)[4:].view(
        2, 2, 64), _view((2, 2, 9, 64)), _view((2, 2, 9, 64)), None), "simt"),
    ("bf16 broadcast slab (batch stride 0)", lambda: (
        _q(16, 8, 64), _view((1, 8, 48, 64), transpose=True).expand(16, -1, -1, -1),
        _view((1, 8, 48, 64), transpose=True).expand(16, -1, -1, -1), None), "split"),
    ("bf16 q, f32 K/V", lambda: (_q(2, 2, 64), _view((2, 2, 9, 64), torch.float32),
                                 _view((2, 2, 9, 64), torch.float32), None), "simt"),
    ("int8 K/V", lambda: (_q(2, 2, 64), _view((2, 2, 9, 64), torch.int8),
                          _view((2, 2, 9, 64), torch.int8), torch.ones(2, 2, 9)), "simt"),
]


def _aligned(*ts):
    return all(t.data_ptr() % da.VEC_BYTES == 0 for t in ts)


@pytest.mark.parametrize("name, make, route", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_decode_route_rule(name, make, route):
    """The route from dtype, head dim, alignment and strides alone. A CPU
    buffer's base is aligned by its allocator, not by this test, so a case
    meant for the split route goes to simt when an allocator hands out a
    base off a 16-byte boundary."""
    q, ck, cv, k_scale = make()
    want = route if route == "simt" or _aligned(q, ck, cv) else "simt"
    assert da.decode_route(q, ck, cv, k_scale) == want
    assert want in da.ROUTES
    # int8 K/V never takes the split route, whatever its layout
    if k_scale is not None:
        assert da.decode_route(q, ck.contiguous(), cv.contiguous(), k_scale) == "simt"


# the cases the wrapper takes (it refuses K/V in another float dtype than q's)
LEGAL_CASES = [c for c in ROUTE_CASES if c[0] != "bf16 q, f32 K/V"]


@pytest.mark.parametrize("name, make, route", LEGAL_CASES, ids=[c[0] for c in LEGAL_CASES])
def test_launch_takes_the_routes_entry_and_counts_it(monkeypatch, name, make, route):
    """On the card the wrapper launches the entry point of the route the
    rule picks and counts it in LAUNCHES and ROUTE_LAUNCHES; here the
    launch is recorded instead of made (CPU tensors, no nvcc)."""
    q, ck, cv, k_scale = make()
    calls = []
    monkeypatch.setattr(da, "_lib", lambda: None)
    monkeypatch.setattr(da._nvcc, "launch", lambda lib, entry, device, *args: calls.append(
        (entry, args)))
    monkeypatch.setattr(da, "LAUNCHES", dict.fromkeys(da.LAUNCHES, 0))
    monkeypatch.setattr(da, "ROUTE_LAUNCHES", dict.fromkeys(da.ROUTE_LAUNCHES, 0))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    kw = {} if k_scale is None else {"k_scale": k_scale, "v_scale": k_scale}
    b, h, total, d = ck.shape
    pos = torch.full((b,), total - 1, dtype=torch.int32)
    da.decode_cache_attention(q, ck, cv, pos, **kw)
    got = da.decode_route(q, ck, cv, k_scale)
    name_ = "decode_attention_q8" if kw else "decode_attention"
    (entry, args), = calls
    assert entry == ("decode_attention_split" if got == "split" else name_)
    assert args[0] == da._DTYPE_CODE[q.dtype] and args[1:4] == (
        q.data_ptr(), ck.data_ptr(), cv.data_ptr())
    assert da.LAUNCHES == {n: int(n == name_) for n in da.LAUNCHES}
    assert da.ROUTE_LAUNCHES == {n: int(n == f"{name_}_{got}") for n in da.ROUTE_LAUNCHES}


@pytest.mark.parametrize("head_dim", [4, 8, 16, 24, 40, 64, 128, 256])
def test_decode_pieces_cover_the_live_prefix_in_order(head_dim):
    """The pieces cover [0, n) exactly, in order, at most MAX_PIECES of
    them, each of piece_rows(n, Dh) rows (a multiple of PIECE_STEP) but the
    last; and they are a function of (n, Dh) alone: the same at every call,
    whatever the cache length, batch or heads around them."""
    for n in list(range(0, 300)) + [511, 512, 513, 1000, 2048, 4097, 65536]:
        pieces = da.decode_pieces(n, head_dim)
        assert len(pieces) <= da.MAX_PIECES
        assert [p for piece in pieces for p in range(*piece)] == list(range(n))
        rows = da.piece_rows(n, head_dim)
        assert rows % da.PIECE_STEP == 0 and rows * head_dim >= da.MIN_PIECE_ELEMS
        assert all(stop - start == rows for start, stop in pieces[:-1])
        assert da.decode_pieces(n, head_dim) == pieces
    assert list(inspect.signature(da.decode_pieces).parameters) == ["n", "head_dim"]


def test_cluster_covers_every_live_length():
    """The kernel's cluster holds ceil(total / piece_rows(1, Dh)) blocks at
    most 8, rounded up to a power of two; every n <= total must have no more
    pieces than that (piece_rows grows with n)."""
    for d in (8, 16, 64, 128):
        first = da.piece_rows(1, d)
        for total in range(1, 1100, 3):
            most = min(da.MAX_PIECES, -(-total // first))
            assert max(len(da.decode_pieces(n, d)) for n in range(total + 1)) <= most


def _split_emulation(q, ck, cv, pos):
    """The split route's function in numpy float32: for each (b, h) the live
    prefix cut by `decode_pieces`; per piece s = (q . k) * scale, m = the
    piece's max, p = exp(s - m) rounded to V's dtype for P.V and summed
    unrounded for l; the pieces merged in order with exp(m_i - max m)
    weights, the denominator clamped at 1e-30, o cast to q's dtype."""
    b, h, total, d = ck.shape
    qf, kf, vf = (t.float().numpy() for t in (q, ck, cv))
    out = np.zeros((b, h, d), np.float32)
    scale = np.float32(1.0 / np.sqrt(d))
    for bi in range(b):
        p_b = int(pos if isinstance(pos, int) else pos.reshape(-1)[bi])
        n = max(0, min(p_b, total - 1) + 1)
        for hi in range(h):
            parts = []
            for start, stop in da.decode_pieces(n, d):
                s = (kf[bi, hi, start:stop] @ qf[bi, hi]).astype(np.float32) * scale
                m = s.max()
                p = np.exp(s - m).astype(np.float32)
                pr = torch.from_numpy(p).to(cv.dtype).float().numpy()
                parts.append((m, p.sum(dtype=np.float32), pr @ vf[bi, hi, start:stop]))
            if not parts:
                continue
            mx = max(m for m, _, _ in parts)
            den, o = np.float32(0), np.zeros(d, np.float32)
            for m, l, acc in parts:
                w = np.float32(np.exp(np.float32(m - mx)))
                den, o = den + l * w, o + acc * w
            out[bi, hi] = o / max(den, np.float32(1e-30))
    return torch.from_numpy(out).to(q.dtype)


@pytest.mark.parametrize("pos", [0, 15, 16, 100, [0, 127], [37, 90]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_emulation_matches_jax_kernel(n_devices, dtype, pos):
    """The split route's order of operations (pieces of 16 rows at Dh 64,
    each with its own max, p rounded per piece, merged in order) against
    the JAX package's Pallas kernel in interpret mode, at the tolerances of
    test_plain_matches_jax_kernel_and_xla_chain; and against the port's
    plain version (the global max) at the same tolerance."""
    rng = np.random.default_rng(17)
    q, ck, cv = (rng.normal(size=s).astype(np.float32) for s in
                 ((2, 2, 64), (2, 2, 128, 64), (2, 2, 128, 64)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpos, tpos = _pos_pair(pos)
    want = jax_decode(*(jnp.asarray(a, jdt) for a in (q, ck, cv)), jpos, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, ck, cv))
    got = _split_emulation(tq, tk, tv, tpos)
    assert len(da.decode_pieces(128, 64)) == 8  # pos [.., 127]: every piece of the cluster
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(got.float(), want, tol)
    _close(got.float(), da.decode_cache_attention(tq, tk, tv, tpos).float(), tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_split_route_matches_plain_and_its_emulation(cuda_device, dtype):
    """On the card: the split kernel against the plain version and the
    emulation of its order, with the same bits in a batch of 1 as in the
    batch, and under another cache length."""
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    g = torch.Generator().manual_seed(3)
    q, ck, cv = (torch.randn(*s, generator=g).to(dtype) for s in
                 ((4, 2, 64), (4, 2, 300, 64), (4, 2, 300, 64)))
    pos = torch.tensor([0, 17, 150, 299], dtype=torch.int32)
    qc, kc, vc, pc = (t.to(cuda_device) for t in (q, ck, cv, pos))
    assert da.decode_route(qc, kc, vc) == "split"
    before = dict(da.ROUTE_LAUNCHES)
    o = da.decode_cache_attention(qc, kc, vc, pc)
    assert da.ROUTE_LAUNCHES["decode_attention_split"] == before["decode_attention_split"] + 1
    torch.testing.assert_close(o.float().cpu(), da.decode_attention_plain(q, ck, cv, pos).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(o.float().cpu(), _split_emulation(q, ck, cv, pos).float(),
                               atol=tol, rtol=tol)
    one = da.decode_cache_attention(qc[2:3].contiguous(), kc[2:3], vc[2:3], pc[2:3])
    assert torch.equal(one, o[2:3])
    cut = da.decode_cache_attention(qc, kc[:, :, :300 - 7], vc[:, :, :300 - 7],
                                    pc.clamp_max(292))
    assert torch.equal(cut[:3], o[:3])
