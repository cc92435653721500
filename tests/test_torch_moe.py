"""The port's `parallel/moe.py` against the JAX package's on the same numpy
inputs.

- `expert_capacity` over a grid of token counts, experts, k and factors:
  equal.
- `sort_route` and `topk_dispatch` on the same probabilities, k in {1, 2,
  3}, capacity in {2, 6, T}: the integer outputs (experts, slots, dispatch)
  equal, the weights, combine tensors and aux within 1e-6.
- `moe_ffn`, sort and dense, against JAX `moe_ffn` (sort; JAX's own tests
  hold its dense form to it), k in {1, 2, 3}, capacity in {2, 6, T}, z-loss
  on and off: the output within 1e-5, the gradients of sum(y * w) + aux
  with respect to x, wr, w1, b1, w2, b2 within 2e-4 (JAX's TestSortDispatch
  bound).
- Expert parallelism over gloo (tests/torch_rank_worker.py, OMP_NUM_THREADS
  = 1): world 2 and 4 with the experts over the data axis, and ep 2 x tp 2 at
  world 4, against JAX `moe_ffn` under `shard_map` on the same mesh of the
  virtual CPU devices: each rank's output block, aux and gradients (the
  router's summed over the data axis) within the same bounds.

Every test asserts that the top-(k+1) gaps of its router probabilities
exceed 1e-5, so that no routing decision rests on float noise (torch.topk
and jax.lax.top_k may order exact ties differently).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

from distributed_neural_network_tpu.parallel import moe as jmoe
from distributed_neural_network_tpu.train import lm as jlm
from distributed_neural_network_tpu_torch.parallel import moe as tmoe

from torch_rank_worker import launch

T, D, E, F = 32, 16, 8, 24
FWD_TOL, GRAD_TOL, ROUTE_TOL = 1e-5, 2e-4, 1e-6
GAP = 1e-5
ENV = {"OMP_NUM_THREADS": "1"}
CAPS = (2, 6, T)


def _inputs(seed, t=T):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(t, D)).astype(np.float32),
            # the router at the model's init scale, 1/sqrt(d)
            "wr": (rng.normal(size=(D, E)) / np.sqrt(D)).astype(np.float32),
            "w1": (rng.normal(size=(E, D, F)) * 0.3).astype(np.float32),
            "b1": (rng.normal(size=(E, F)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(E, F, D)) * 0.3).astype(np.float32),
            "b2": (rng.normal(size=(E, D)) * 0.1).astype(np.float32),
            "w": rng.normal(size=(t, D)).astype(np.float32)}


def _probs(inp):
    return np.asarray(jax.nn.softmax(jnp.asarray(inp["x"]) @ jnp.asarray(inp["wr"]), axis=-1))


def _assert_margins(probs, k):
    """Each token's top-(k+1) probabilities differ by more than GAP."""
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    gaps = top[:, :-1] - top[:, 1:]
    assert gaps.min() > GAP, f"a routing margin {gaps.min()} is within float noise"


def test_expert_capacity_is_the_jax_one():
    for n in (1, 7, 64, 1000, 32768):
        for e in (1, 4, 8, 64):
            for k in (1, 2, 3):
                for f in (0.5, 1.0, 1.25, 2.0):
                    assert (tmoe.expert_capacity(n, e, k, f)
                            == jmoe.expert_capacity(n, e, k, f)), (n, e, k, f)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("cap", CAPS)
def test_routing_matches_jax(k, cap):
    probs = _probs(_inputs(1))
    _assert_margins(probs, k)
    je, js, jw, jaux = jmoe.sort_route(jnp.asarray(probs), k, cap)
    te, ts, tw, taux = tmoe.sort_route(torch.from_numpy(probs), k, cap)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ROUTE_TOL, rtol=0)
    assert abs(float(taux) - float(jaux)) <= ROUTE_TOL
    jc, jd, jaux = jmoe.topk_dispatch(jnp.asarray(probs), k, cap)
    tc, td, taux = tmoe.topk_dispatch(torch.from_numpy(probs), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ROUTE_TOL, rtol=0)
    assert abs(float(taux) - float(jaux)) <= ROUTE_TOL


def _jax_ffn(inp, k, cap, z, ep_axis=None, tp_axis=None):
    def loss(*a):
        y, aux = jmoe.moe_ffn(*a, top_k=k, capacity=cap, z_loss_weight=z, ep_axis=ep_axis,
                              tp_axis=tp_axis)
        return jnp.sum(y * inp["w"]) + aux, (y, aux)

    args = [jnp.asarray(inp[n]) for n in ("x", "wr", "w1", "b1", "w2", "b2")]
    (_, (y, aux)), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("z", [0.0, 0.1])
def test_moe_ffn_forward_and_gradients_match_jax(k, cap, z):
    inp = _inputs(2)
    _assert_margins(_probs(inp), k)
    want_y, want_aux, want_g = _jax_ffn(inp, k, cap, z)
    for impl in ("sort", "dense"):
        ins = [torch.from_numpy(inp[n]).requires_grad_() for n in
               ("x", "wr", "w1", "b1", "w2", "b2")]
        y, aux = tmoe.moe_ffn(*ins, top_k=k, capacity=cap, dispatch_impl=impl, z_loss_weight=z)
        ((y * torch.from_numpy(inp["w"])).sum() + aux).backward()
        np.testing.assert_allclose(y.detach().numpy(), want_y, atol=FWD_TOL, rtol=FWD_TOL)
        assert abs(float(aux) - want_aux) <= FWD_TOL
        for name, t, g in zip(("x", "wr", "w1", "b1", "w2", "b2"), ins, want_g):
            np.testing.assert_allclose(t.grad.numpy(), g, atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{impl} grad {name}")


def test_dispatch_impl_is_checked():
    inp = _inputs(2)
    with pytest.raises(ValueError, match="dispatch_impl"):
        tmoe.moe_ffn(*(torch.from_numpy(inp[n]) for n in ("x", "wr", "w1", "b1", "w2", "b2")),
                     capacity=4, dispatch_impl="scatter")


# name -> (world, (dp, tp), k, capacity (of a rank's T/dp tokens), dispatch, z)
EP_CASES = {
    "ep2-k2": (2, (2, 1), 2, 4, "sort", 0.1),
    "ep2-k1-dense": (2, (2, 1), 1, 16, "dense", 0.0),
    "ep4-k2": (4, (4, 1), 2, 2, "sort", 0.1),
    "ep4-k3-nodrop": (4, (4, 1), 3, 8, "sort", 0.0),
    "ep2tp2-k2": (4, (2, 2), 2, 4, "sort", 0.1),
}


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor

    d = tmp_path_factory.mktemp("moe_ep")
    np.savez(d / "inputs.npz", **_inputs(3))
    jobs = {}
    with ThreadPoolExecutor(2) as pool:
        for w in (2, 4):
            (d / f"w{w}").mkdir()
            cases = [{"name": n, "mesh": list(m), "top_k": k, "capacity": c, "impl": i, "z": z}
                     for n, (world, m, k, c, i, z) in EP_CASES.items() if world == w]
            spec = {"device": "cpu", "out": str(d / f"w{w}"),
                    "moe": {"inputs": str(d / "inputs.npz"), "cases": cases}}
            jobs[w] = pool.submit(launch, w, spec, timeout=180, env=ENV)
        for w, fut in jobs.items():
            for p in fut.result():
                assert p.returncode == 0, f"world {w}: {p.stderr[-3000:]}"
    return {n: [dict(np.load(d / f"w{w}" / f"moe_{n}_rank{r}.npz")) for r in range(w)]
            for n, (w, *_) in EP_CASES.items()}


def _jax_ep(inp, dp, tp, k, cap, impl, z):
    """JAX `moe_ffn` under shard_map on create_lm_mesh(dp, 1, tp): y, the
    per-shard aux and the gradients of sum(y * w) + sum(aux)."""
    mesh = jlm.create_lm_mesh(dp, 1, tp)
    tpa = "model" if tp > 1 else None
    specs = (JP("data"), JP(), JP("data", None, tpa), JP("data", tpa), JP("data", tpa, None),
             JP("data"))

    def body(x, wr, w1, b1, w2, b2):
        y, aux = jmoe.moe_ffn(x, wr, w1, b1, w2, b2, top_k=k, capacity=cap, ep_axis="data",
                              tp_axis=tpa, dispatch_impl=impl, z_loss_weight=z)
        return y, aux[None]

    fn = jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=(JP("data"), JP("data")))

    def loss(*a):
        y, aux = fn(*a)
        return jnp.sum(y * inp["w"]) + jnp.sum(aux), (y, aux)

    args = [jnp.asarray(inp[n]) for n in ("x", "wr", "w1", "b1", "w2", "b2")]
    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                                      has_aux=True))(*args)
    return np.asarray(y), np.asarray(aux), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(EP_CASES))
def test_expert_parallel_moe_ffn_matches_jax_shard_map(n_devices, ep_ranks, case):
    world, (dp, tp), k, cap, impl, z = EP_CASES[case]
    inp = _inputs(3)
    _assert_margins(_probs(inp), k)
    want_y, want_aux, want_g = _jax_ep(inp, dp, tp, k, cap, impl, z)
    t_rows, e_rows, f_cols = T // dp, E // dp, F // tp
    for r, got in enumerate(ep_ranks[case]):
        d_i, t_i = r // tp, r % tp
        rows, ex, cols = (slice(d_i * t_rows, (d_i + 1) * t_rows),
                          slice(d_i * e_rows, (d_i + 1) * e_rows),
                          slice(t_i * f_cols, (t_i + 1) * f_cols))
        np.testing.assert_allclose(got["y"], want_y[rows], atol=FWD_TOL, rtol=FWD_TOL)
        assert abs(float(got["aux"]) - float(want_aux[d_i])) <= FWD_TOL
        blocks = {"x": want_g[0][rows], "wr": want_g[1], "w1": want_g[2][ex][:, :, cols],
                  "b1": want_g[3][ex][:, cols], "w2": want_g[4][ex][:, cols],
                  "b2": want_g[5][ex]}
        for name, want in blocks.items():
            np.testing.assert_allclose(got["grad_" + name], want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"rank {r} grad {name}")
