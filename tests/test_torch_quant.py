"""The port's `ops/quant.py` against the JAX package's on the same numpy
inputs.

Tolerances: int8 and fp8 codes bitwise equal; scales within 1 f32 ulp (the
same division); dequantize, quantized_matmul and quantized_attention within
atol = rtol = 1e-5 (f32 sums in another order; the code products are exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_neural_network_tpu.ops import quant as jq
from distributed_neural_network_tpu_torch.ops import quant as tq

TOL = 1e-5


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * scale
    x[..., 0] = 0.0  # exact zeros stay exact
    return x.astype(np.float32)


def _codes(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype != np.int8 else np.asarray(x)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("block", [None, 4])
def test_quantize_codes_bitwise_scales_one_ulp(fmt, block):
    x = _x((3, 5, 16), seed=1, scale=3.0)
    x[1, 2] = 0.0  # an all-zero row: scale at the floor, codes exactly 0
    jc, js = jq.quantize(jnp.asarray(x), fmt, block=block)
    tc, ts = tq.quantize(torch.from_numpy(x), fmt, block=block)
    assert tc.dtype == tq.QUANT_FORMATS[fmt][0]
    np.testing.assert_array_equal(tc.float().numpy(), _codes(jc))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)
    back = tq.dequantize(tc, ts, block=block).numpy()
    np.testing.assert_allclose(back, np.asarray(jq.dequantize(jc, js, block=block)),
                               atol=TOL, rtol=TOL)
    got, want = tq.roundtrip_error(torch.from_numpy(x), fmt, block=block), \
        jq.roundtrip_error(jnp.asarray(x), fmt, block=block)
    for key in ("mae", "max_abs", "rel"):
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-7)


def test_fp8_clamps_instead_of_nan_and_int8_rounds_half_even():
    codes, scale = tq.quantize(torch.tensor([[448.0, -1000.0, 2.0]]), "fp8")
    assert torch.isfinite(codes.float()).all() and codes.float().abs().max() == 448.0
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5]])  # amax 127 -> scale 1
    codes, _ = tq.quantize(x, "int8")
    assert codes.tolist() == [[127, 0, 2, 2, 0]]
    with pytest.raises(ValueError, match="unknown quantized format"):
        tq.quantize(x, "int4")
    with pytest.raises(ValueError, match="must divide"):
        tq.quantize(x, "int8", block=2)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("mode", ["both", "weight_only", "prequantized"])
def test_quantized_matmul_matches_jax(fmt, mode):
    a, b = _x((6, 24), seed=2), _x((24, 10), seed=3)
    if mode == "prequantized":
        jb = jq.prequantize_weight(jnp.asarray(b), fmt)
        tb = tq.prequantize_weight(torch.from_numpy(b), fmt)
        np.testing.assert_array_equal(tb[0].float().numpy(), _codes(jb[0]))
    else:
        jb, tb = jnp.asarray(b), torch.from_numpy(b)
    kw = {"weight_only": mode == "weight_only"}
    want = np.asarray(jq.quantized_matmul(jnp.asarray(a), jb, fmt, **kw))
    got = tq.quantized_matmul(torch.from_numpy(a), tb, fmt, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("causal", [True, False])
def test_quantized_attention_matches_jax(fmt, causal):
    q, k, v = (_x((2, 12, 3, 8), seed=s, scale=0.7) for s in (4, 5, 6))
    want = np.asarray(jq.quantized_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                             causal=causal, fmt=fmt))
    got = tq.quantized_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, fmt=fmt).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
