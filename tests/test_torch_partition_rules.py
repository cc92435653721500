"""The partition layer: the port's `parallel/partition.py` spec checks and
`parallel/rules.py` rule table against the JAX package's, on the same
trees: the spec trees the LM rule table gives (dp only, tp, ep), the error
texts of a bad axis, a doubled axis, a too-long spec, an uneven shard and an
unmatched leaf, and the rules-file JSON round trip in both directions (a
file written by either package loads in the other). Specs are compared as
tuples of entries."""

import json

import pytest
from jax.sharding import PartitionSpec as JP

from distributed_neural_network_tpu.models import transformer as jtfm
from distributed_neural_network_tpu.parallel import partition as jpart
from distributed_neural_network_tpu.parallel import rules as jrules
from distributed_neural_network_tpu_torch.models import transformer as tfm
from distributed_neural_network_tpu_torch.parallel import partition as tpart
from distributed_neural_network_tpu_torch.parallel import rules as trules
from distributed_neural_network_tpu_torch.parallel.partition import PartitionSpec as TP

KW = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _as_tuples(named):
    return [(path, tuple(spec)) for path, spec in named]


def _jnamed(specs):
    return jrules.named_leaves(specs, is_leaf=lambda s: isinstance(s, JP))


def _tnamed(specs):
    return trules.named_leaves(specs, is_leaf=lambda s: isinstance(s, TP))


@pytest.mark.parametrize("axes", [{}, {"tp_axis": "model"}, {"tp_axis": "model",
                                                             "ep_axis": "data"}])
def test_lm_rule_table_and_spec_tree_match_jax(axes):
    jspecs = jtfm.param_specs(jtfm.TransformerConfig(**KW), **axes)
    tspecs = tfm.param_specs(tfm.TransformerConfig(**KW), **axes)
    assert _as_tuples(_tnamed(tspecs)) == _as_tuples(_jnamed(jspecs))
    assert [(p, tuple(s)) for p, s in trules.lm_partition_rules(**axes)] == [
        (p, tuple(s)) for p, s in jrules.lm_partition_rules(**axes)]
    assert [p for p, _ in trules.named_leaves(tfm.param_skeleton(tfm.TransformerConfig(**KW)))] \
        == [p for p, _ in jrules.named_leaves(jtfm.param_skeleton(jtfm.TransformerConfig(**KW)))]


def test_moe_rules_match_jax():
    want = jrules.lm_partition_rules(tp_axis="model", ep_axis="data", n_experts=4)
    got = trules.lm_partition_rules(tp_axis="model", ep_axis="data", n_experts=4)
    assert [(p, tuple(s)) for p, s in got] == [(p, tuple(s)) for p, s in want]


def test_spec_repr_is_jax_s():
    for entries in ((), (None, None, "model"), (("a", "b"), None), ("data",)):
        assert repr(TP(*entries)) == repr(JP(*entries)) == str(TP(*entries))


@pytest.mark.parametrize("entries,mesh,shape", [
    (("nope",), {"data": 2}, None),             # an axis the mesh lacks
    (("data", "data"), {"data": 2}, None),      # an axis twice
    ((None, "data", None), {"data": 2}, (4, 4)),  # longer than the rank
    ((None, "data"), {"data": 4}, (4, 6)),      # an uneven shard
    ((("data", "model"),), {"data": 2, "model": 3}, (8,)),  # a tuple entry, uneven
])
def test_validate_partition_spec_errors_match_jax(entries, mesh, shape):
    with pytest.raises(ValueError) as want:
        jpart.validate_partition_spec(JP(*entries), mesh, shape=shape, name="params['w']")
    with pytest.raises(ValueError) as got:
        tpart.validate_partition_spec(TP(*entries), mesh, shape=shape, name="params['w']")
    assert str(got.value) == str(want.value)


def test_validate_spec_tree_names_the_leaf_as_jax_does():
    import numpy as np

    jt = {"layers": {"wq": JP(None, "data")}, "head": JP(), "l": [JP(), JP("model")]}
    tt = {"layers": {"wq": TP(None, "data")}, "head": TP(), "l": [TP(), TP("model")]}
    for mesh in ({"data": 2}, {"data": 2, "model": 2}):
        errors = []
        for specs, mod in ((jt, jpart), (tt, tpart)):
            try:
                mod.validate_spec_tree(specs, mesh, root="params")
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        assert errors[0] == errors[1]
    shapes = {"layers": {"wq": np.zeros((2, 3))}, "head": np.zeros(3), "l": [np.zeros(2),
                                                                               np.zeros(4)]}
    mesh = {"data": 2, "model": 2}
    with pytest.raises(ValueError) as want:
        jpart.validate_spec_tree(jt, mesh, shapes=shapes)
    with pytest.raises(ValueError) as got:
        tpart.validate_spec_tree(tt, mesh, shapes=shapes)
    assert str(got.value) == str(want.value)


def test_unmatched_leaf_and_bad_rule_errors_match_jax():
    tree = {"embed": 0, "extra": 0}
    with pytest.raises(ValueError) as want:
        jrules.match_partition_rules([(r"^embed$", JP())], tree)
    with pytest.raises(ValueError) as got:
        trules.match_partition_rules([(r"^embed$", TP())], tree)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="not a PartitionSpec"):
        trules.match_partition_rules([(r".*", (None,))], tree)


def test_rules_to_spec_tree_checks_the_mesh():
    import torch

    params = tfm.init_params(0, tfm.TransformerConfig(**KW))
    rules = trules.lm_partition_rules(tp_axis="model")
    specs = trules.rules_to_spec_tree(rules, params, {"data": 2, "model": 2})
    assert tuple(specs["layers"]["wq"]) == (None, None, "model")
    with pytest.raises(ValueError, match="mesh only has axes"):
        trules.rules_to_spec_tree(rules, params, {"data": 2})
    # scalars skip the rules
    assert tuple(trules.match_partition_rules([], {"t": torch.zeros(())})["t"]) == ()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_rules_files_cross_between_the_packages(tmp_path, writer, reader):
    mods = {"jax": jrules, "torch": trules}
    specs = {"jax": JP, "torch": TP}
    rules = [(r"^embed$", specs[writer]()), (r"(^|/)w[qkv]$", specs[writer](None, None, "model")),
             (r"(^|/)w1$", specs[writer](None, ("data", "model"))), (r".*", specs[writer]())]
    path = mods[writer].save_rules(rules, str(tmp_path / "rules.json"))
    loaded = mods[reader].load_rules(path)
    assert [(p, tuple(s)) for p, s in loaded] == [(p, tuple(s)) for p, s in rules]
    assert all(isinstance(s, specs[reader]) for _, s in loaded)
    assert trules.rules_to_json(loaded if reader == "torch" else
                                [(p, TP(*s)) for p, s in loaded]) == json.load(open(path))
    assert mods[reader].format_rules(loaded) == mods[writer].format_rules(rules)


@pytest.mark.parametrize("doc,match", [
    ({"a": 1}, "JSON list"), ([["x"]], "entry 0"), ([["(", []]], "not a valid regex")])
def test_bad_rules_documents_fail_as_in_jax(tmp_path, doc, match):
    path = tmp_path / "r.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match=match) as got:
        trules.load_rules(str(path))
    with pytest.raises(ValueError) as want:
        jrules.load_rules(str(path))
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError, match="save_rules"):
        trules.load_rules(str(tmp_path / "missing.json"))


def test_lm_wiring_keeps_the_data_axis_replicated(tmp_path):
    """The port's dp wiring: replicated specs from the table, zero state
    sharded over data, and a rules file that shards a leaf refused (tensor
    sharding comes with TP; zero needs replicated specs)."""
    from distributed_neural_network_tpu_torch.parallel.mesh import ProcessMesh
    from distributed_neural_network_tpu_torch.train import lm as tlm

    import torch

    cfg = tfm.TransformerConfig(**KW)
    mesh = ProcessMesh(1, torch.device("cpu"))
    _, _, _, sync, specs, mom_spec, data_spec = tlm.lm_wiring(cfg, mesh, "zero-adam")
    assert all(e is None for _, s in _tnamed(specs) for e in s)
    assert tuple(mom_spec["m"]["layers"]["wq"]) == ("data",) and tuple(data_spec) == (
        "data", "seq")
    specs2, psh, msh = tlm.make_lm_shardings(cfg, mesh, "zero")
    assert psh["head"].mesh is mesh and tuple(msh["head"].spec) == ("data",)
    sharded = [(r"(^|/)w1$", TP(None, None, "data")), (r".*", TP())]
    with pytest.raises(ValueError, match="requires fully replicated"):
        tlm.lm_wiring(cfg, mesh, "zero", rules=sharded)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tlm.lm_wiring(cfg, ProcessMesh(2, torch.device("cpu")), "sgd", rules=sharded)
