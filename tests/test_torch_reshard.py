"""The port's resharder (`parallel/reshard.py`, `train/elastic.py`'s host
functions) held to the JAX package's on the same seeded numpy inputs, bit
for bit: the spec JSON helpers, the ZeRO layout transforms at dp 1, 2 and 4
and the pipeline's ZeRO split at pp 2, every optimizer conversion of
sgd / zero / adam / zero-adam, `reshard_state`, `rescale_accum` over a grid,
`reshard_momentum_stack`, `pp_param_specs_for_tree`, `saved_state_template`
and `rescaled_accum_steps`; and the collective reassembly
(`make_zero_gather_fn`, `make_pp_zero_gather_fn`) on gloo ranks against its
host transform (`tests/torch_rank_worker.py` "reshard": dp 2, dp 4 and dp
2 x pp 2, OMP_NUM_THREADS=1)."""

import itertools
import json

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.parallel import pipeline as jpp
from distributed_neural_network_tpu.parallel import reshard as JR
from distributed_neural_network_tpu.train import elastic as JE
from distributed_neural_network_tpu_torch.models import transformer as ptfm
from distributed_neural_network_tpu_torch.parallel import pipeline as ppp
from distributed_neural_network_tpu_torch.parallel import reshard as PR
from distributed_neural_network_tpu_torch.parallel.partition import PartitionSpec as PP
from distributed_neural_network_tpu_torch.train import elastic as PE
from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

from torch_rank_worker import launch

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
OPTIMIZERS = ("sgd", "zero", "adam", "zero-adam")


def _trees(seed=0, **kw):
    """(params, momentum, second moment) as numpy trees of the JAX
    parameters' shapes (JAX's own init for the params), the others seeded."""
    cfg = jtfm.TransformerConfig(**{**CFG, **kw})
    params = jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    draw = lambda: jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                params)
    return params, draw(), draw()


def _same(a, b):
    """Two trees (the port's, JAX's) leaf for leaf: same structure, dtype,
    shape and bytes."""
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def _state(optimizer, dp, mom, v, params):
    """The optimizer's state in its own layout at `dp` (numpy)."""
    if optimizer == "sgd":
        return mom
    if optimizer == "zero":
        return JR.momentum_to_zero_tree(mom, dp)
    if optimizer == "adam":
        return {"m": mom, "v": v, "t": np.int32(5)}
    return {"m": JR.momentum_to_zero_tree(mom, dp), "v": JR.momentum_to_zero_tree(v, dp),
            "t": np.int32(5)}


def _jspecs_as_port(tree):
    return jax.tree.map(lambda s: PP(*tuple(s)), tree, is_leaf=lambda s: isinstance(s, JP))


# ------------------------------------------------------------ specs


def test_spec_json_helpers_match_jax():
    cfg = jtfm.TransformerConfig(**CFG)
    jspecs = jpp.pp_param_specs(cfg)
    pspecs = ppp.pp_param_specs(ptfm.TransformerConfig(**CFG))
    doc = PR.spec_tree_to_json(pspecs)
    assert json.dumps(doc, sort_keys=True) == json.dumps(JR.spec_tree_to_json(jspecs),
                                                         sort_keys=True)
    assert PR.spec_tree_from_json(doc) == _jspecs_as_port(JR.spec_tree_from_json(doc))
    for entries in (["data"], [None, ["pipe", "data"]], [], [None, "model"]):
        assert tuple(PR.spec_from_json(entries)) == tuple(JR.spec_from_json(entries))
        assert PR.spec_axes(PR.spec_from_json(entries)) == JR.spec_axes(
            JR.spec_from_json(entries))
    params, _, _ = _trees()
    assert PR.pp_param_specs_for_tree(params) == _jspecs_as_port(
        JR.pp_param_specs_for_tree(params))


# ------------------------------------------------------ ZeRO transforms


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_zero_transforms_match_jax(dp):
    params, mom, _ = _trees()
    flat = JR.momentum_to_zero_tree(mom, dp)
    _same(PR.momentum_to_zero_tree(mom, dp), flat)
    _same(PR.zero_tree_to_momentum(flat, params), JR.zero_tree_to_momentum(flat, params))
    for new in (1, 2, 4, 3):
        _same(PR.reshard_zero_tree(flat, params, new), JR.reshard_zero_tree(flat, params, new))
    leaf = flat["embed"]
    _same({"x": PR.reshard_zero_leaf(leaf, params["embed"].size, 4)},
          {"x": JR.reshard_zero_leaf(leaf, params["embed"].size, 4)})
    for bad in (leaf[:3], leaf.reshape(-1, 1)):
        with pytest.raises(ValueError) as jerr:
            JR.reshard_zero_leaf(bad, params["embed"].size, 2)
        with pytest.raises(ValueError, match=str(jerr.value).replace("(", r"\(")
                           .replace(")", r"\)")):
            PR.reshard_zero_leaf(bad, params["embed"].size, 2)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_pipeline_zero_split_matches_jax(dp):
    params, mom, _ = _trees(n_layers=4)
    jspecs = jpp.pp_param_specs(jtfm.TransformerConfig(**{**CFG, "n_layers": 4}))
    pspecs = ppp.pp_param_specs(ptfm.TransformerConfig(**{**CFG, "n_layers": 4}))
    flat = JR.momentum_to_pp_zero_tree(mom, jspecs, 2, dp)
    _same(PR.momentum_to_pp_zero_tree(mom, pspecs, 2, dp), flat)
    _same(PR.pp_zero_tree_to_momentum(flat, params, pspecs, 2),
          JR.pp_zero_tree_to_momentum(flat, params, jspecs, 2))
    _same(PR.pp_zero_tree_to_momentum(flat, params, pspecs, 2), mom)


# ------------------------------------------------ optimizer conversions


@pytest.mark.parametrize("src,dst", [(a, b) for a in OPTIMIZERS for b in OPTIMIZERS
                                     if (a in ("sgd", "zero")) == (b in ("sgd", "zero"))])
def test_convert_optimizer_state_matches_jax(src, dst):
    params, mom, v = _trees()
    for src_dp, dst_dp in itertools.product((1, 2, 4), repeat=2):
        state = _state(src, src_dp, mom, v, params)
        kw = dict(src=src, dst=dst, params_template=params, src_dp=src_dp, dst_dp=dst_dp)
        got = PR.convert_optimizer_state(state, **kw)
        _same(got, JR.convert_optimizer_state(state, **kw))
        _same(got, _state(dst, dst_dp, mom, v, params))  # the logical values kept
        both = {"params": params, "mom": state}
        rkw = dict(saved_optimizer=src, saved_dp=src_dp, optimizer=dst, dp=dst_dp,
                   params_template=params)
        _same(PR.reshard_state(both, **rkw), JR.reshard_state(both, **rkw))


@pytest.mark.parametrize("src,dst", [("zero", "sgd"), ("zero-adam", "zero-adam"),
                                     ("sgd", "zero"), ("adam", "zero-adam")])
def test_convert_pipeline_zero_state_matches_jax(src, dst):
    params, mom, v = _trees(n_layers=4)
    jspecs = jpp.pp_param_specs(jtfm.TransformerConfig(**{**CFG, "n_layers": 4}))
    pspecs = ppp.pp_param_specs(ptfm.TransformerConfig(**{**CFG, "n_layers": 4}))
    for (src_dp, src_pp), (dst_dp, dst_pp) in (((2, 2), (1, 1)), ((1, 1), (2, 2)),
                                               ((2, 2), (4, 2)), ((4, 1), (2, 2))):
        if src.startswith("zero") and src_pp > 1:
            flat = lambda m: JR.momentum_to_pp_zero_tree(m, jspecs, src_pp, src_dp)
            state = (flat(mom) if src == "zero" else
                     {"m": flat(mom), "v": flat(v), "t": np.int32(3)})
        else:
            state = _state(src, src_dp, mom, v, params)
        kw = dict(src=src, dst=dst, params_template=params, src_dp=src_dp, dst_dp=dst_dp,
                  src_pp=src_pp, dst_pp=dst_pp)
        _same(PR.convert_optimizer_state(state, pp_specs=pspecs, **kw),
              JR.convert_optimizer_state(state, pp_specs=jspecs, **kw))


@pytest.mark.parametrize("src,dst", [("sgd", "adam"), ("zero", "zero-adam"), ("adam", "zero"),
                                     ("lion", "sgd"), ("sgd", "lion")])
def test_conversion_errors_are_jax_s(src, dst):
    params, mom, v = _trees()
    state = _state(src if src != "lion" else "sgd", 1, mom, v, params)
    kw = dict(src=src, dst=dst, params_template=params, src_dp=1, dst_dp=2)
    with pytest.raises(ValueError) as jerr:
        JR.convert_optimizer_state(state, **kw)
    with pytest.raises(ValueError) as perr:
        PR.convert_optimizer_state(state, **kw)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        JR.convert_optimizer_state(mom, src="zero", dst="sgd", params_template=params,
                                   src_dp=2, dst_dp=1, src_pp=2)
    with pytest.raises(ValueError) as perr:
        PR.convert_optimizer_state(mom, src="zero", dst="sgd", params_template=params,
                                   src_dp=2, dst_dp=1, src_pp=2)
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------ batches and the CNN stack


def test_rescale_accum_matches_jax_over_a_grid():
    for batch, old, new, accum in itertools.product((6, 8, 12, 16, 32), range(1, 9),
                                                    range(1, 9), (1, 2, 3, 4)):
        try:
            want = JR.rescale_accum(batch, old, new, accum)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                PR.rescale_accum(batch, old, new, accum)
            assert str(err.value) == str(e)
            continue
        assert PR.rescale_accum(batch, old, new, accum) == want
    for bad in ((0, 1, 1, 1), (8, 0, 1, 1), (8, 1, 1, 0)):
        with pytest.raises(ValueError) as e:
            JR.rescale_accum(*bad)
        with pytest.raises(ValueError) as err:
            PR.rescale_accum(*bad)
        assert str(err.value) == str(e.value)


@pytest.mark.parametrize("saved", [
    {"global_batch": 32, "accum_steps": 1, "axes": {"data": 8}},
    {"global_batch": 32, "accum_steps": 2, "axes": {"data": 2}},
    {"global_batch": 16, "accum_steps": 1, "axes": {"data": 4}},
    {"axes": {"data": 4}},
])
def test_rescaled_accum_steps_matches_jax(saved):
    for new_dp, accum in itertools.product((1, 2, 4, 8), (1, 2)):
        kw = dict(batch=32, new_dp=new_dp, accum_steps=accum)
        assert PE.rescaled_accum_steps(saved, **kw) == JE.rescaled_accum_steps(saved, **kw)


@pytest.mark.parametrize("n_new", [1, 2, 3, 4, 6, 8])
def test_reshard_momentum_stack_matches_jax(n_new):
    rng = np.random.default_rng(4)
    stack = {"conv1": {"kernel": rng.standard_normal((4, 5, 5, 3, 6)).astype(np.float32),
                       "bias": rng.standard_normal((4, 6)).astype(np.float32)}}
    _same(PR.reshard_momentum_stack(stack, n_new), JR.reshard_momentum_stack(stack, n_new))
    with pytest.raises(ValueError, match="n_new must be >= 1"):
        PR.reshard_momentum_stack(stack, 0)


# --------------------------------------------------- the saved template


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("axes", [{"data": 1}, {"data": 2}, {"data": 4},
                                  {"data": 2, "pipe": 2}, {"data": 1, "pipe": 2}])
def test_saved_state_template_matches_jax(optimizer, axes):
    kw = {**CFG, "n_layers": 4}
    saved = {"optimizer": optimizer, "axes": axes}
    want = JE.saved_state_template(jtfm.TransformerConfig(**kw), saved)
    got = PE.saved_state_template(ptfm.TransformerConfig(**kw), saved)
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape) and np.dtype(g.dtype) == np.dtype(w.dtype)


def test_saved_state_template_refuses_an_unknown_optimizer():
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        PE.saved_state_template(ptfm.TransformerConfig(**CFG), {"optimizer": "lion"})


# ------------------------------------------- the gathers on gloo ranks


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    """dp 2 on 2 ranks; dp 4 and dp 2 x pp 2 on 4 ranks (one launch each)."""
    spec = {"seed": 7, "cfg": {**CFG, "n_layers": 4}}
    out = {}
    jobs = {2: [[2, 1]], 4: [[4, 1], [2, 2]]}
    for world, cases in jobs.items():
        d = tmp_path_factory.mktemp(f"w{world}")
        procs = launch(world, {"device": "cpu", "out": str(d),
                               "reshard": {**spec, "cases": cases}},
                       timeout=150, env={"OMP_NUM_THREADS": "1"})
        for p in procs:
            assert p.returncode == 0, p.stderr[-3000:]
        out[world] = [json.loads((d / f"reshard_rank{r}.json").read_text())
                      for r in range(world)]
    return out


@pytest.mark.parametrize("world,case", [(2, "dp2pp1"), (4, "dp4pp1"), (4, "dp2pp2")])
def test_zero_gathers_are_their_host_transforms_bitwise(gathered, world, case):
    """Each rank's shards cut by `place_tree`, reassembled by the gather
    function's all-gathers (gloo form): every leaf the host transform's
    bytes, and the momentum tree the shards were made from."""
    for r, rec in enumerate(gathered[world]):
        row = rec[case]
        assert row["leaves"] == 16 and row["form"] == "gloo", (r, row)  # 4 + 12 layer leaves
        assert row["bitwise"] and row["bitwise_mom"], (r, row)
