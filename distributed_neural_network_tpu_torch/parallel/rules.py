"""Declarative partition rules: regex -> PartitionSpec over named trees (the
port of the JAX package's `parallel/rules.py`).

An ordered list of ``(regex, PartitionSpec)`` rules is matched against each
leaf's ``/``-joined tree path ("layers/wq"), first match wins, and a leaf no
rule matches is an error naming the path and the patterns tried.

- `match_partition_rules(rules, tree)`: the matcher; returns a spec tree in
  the shape of ``tree``.
- `rules_to_spec_tree(rules, tree, mesh_axes)`: match, then check the specs
  against the mesh's axes (and the leaves' shapes when ``tree`` holds
  tensors) with `partition.validate_spec_tree`.
- `lm_partition_rules(...)`: the transformer family's table;
  `models/transformer.py` `param_specs` is a matcher call over it.
- `rules_to_json` / `rules_from_json` / `save_rules` / `load_rules`: the
  ``--sharding rules:<file>`` document, a JSON list of ``[pattern,
  spec-entries]`` pairs in the JAX package's encoding (a tuple entry is a
  list), so a file written by either package loads in the other.

The specs are the port's `parallel/partition.py` `PartitionSpec`. The port
runs the data axis only: every spec the table gives there is replicated
(the data axis shards the batch, not the parameters), and the zero
optimizers require that.
"""

from __future__ import annotations

import json
import re

from ..utils.tree import is_node, tree_leaves, tree_unflatten
from .partition import PartitionSpec as P

SEP = "/"


def named_leaves(tree, *, sep: str = SEP, is_leaf=None):
    """[(path, leaf)] with dict keys (sorted) and sequence indices
    ``sep``-joined ("layers/wq", "m/layers/wq", ...): the names the rules
    match. ``is_leaf(x)`` true stops the walk at ``x``; ``None`` is an empty
    subtree, as in JAX."""

    def walk(node, keys):
        if node is None:
            return []
        if is_leaf is not None and is_leaf(node):
            return [(sep.join(keys), node)]
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k], keys + (str(k),))]
        if is_node(node):
            return [x for i, v in enumerate(node) for x in walk(v, keys + (str(i),))]
        return [(sep.join(keys), node)]

    return walk(tree, ())


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def match_partition_rules(rules, tree, *, sep: str = SEP, skip_scalars: bool = True):
    """Spec tree for ``tree``: each leaf gets the spec of the FIRST rule
    whose regex ``re.search``-matches its path. ``skip_scalars`` maps rank-0
    and size-1 leaves to ``PartitionSpec()`` without consulting the rules.
    An unmatched leaf raises `ValueError` naming the path and every pattern
    tried; a partial layout is never returned."""
    rules = list(rules)
    for pattern, spec in rules:
        if not isinstance(spec, P):
            raise TypeError(
                f"rule {pattern!r} maps to {spec!r} ({type(spec).__name__}), not a "
                "PartitionSpec - build rules as (regex, PartitionSpec) pairs (load_rules "
                "decodes the JSON form)")

    def spec_for(name, leaf):
        if skip_scalars and hasattr(leaf, "shape"):
            if len(leaf.shape) == 0 or _numel(leaf.shape) == 1:
                return P()
        for pattern, spec in rules:
            if re.search(pattern, name) is not None:
                return spec
        raise ValueError(
            f"no partition rule matches leaf {name!r} - every leaf must be matched "
            f"(first-match-wins over {[p for p, _ in rules]!r}); add a rule, or a "
            "catch-all ('.*', PartitionSpec()) for replicated leftovers")

    return tree_unflatten(tree, [spec_for(n, x) for n, x in named_leaves(tree, sep=sep)])


def rules_to_spec_tree(rules, tree, mesh_axes, *, root: str = "params", sep: str = SEP,
                       skip_scalars: bool = True):
    """`match_partition_rules` then `partition.validate_spec_tree`: the spec
    tree, already checked against the mesh axes (and the leaves' shapes
    when ``tree`` holds tensors), failing with the leaf path named."""
    from .partition import validate_spec_tree

    specs = match_partition_rules(rules, tree, sep=sep, skip_scalars=skip_scalars)
    has_shapes = any(hasattr(leaf, "shape") for leaf in tree_leaves(tree))
    validate_spec_tree(specs, dict(mesh_axes), shapes=tree if has_shapes else None, root=root)
    return specs


def lm_partition_rules(*, tp_axis: str | None = None, ep_axis: str | None = None,
                       n_experts: int = 0):
    """The transformer family's layout: dp only (both axes None: every leaf
    replicated), tensor parallel (``tp_axis``: wq/wk/wv and w1
    column-sharded, wo/w2 row-sharded, b1 with its columns), expert parallel
    (``ep_axis`` shards the expert dim of MoE leaves; the router stays
    replicated). Leaf paths are the stacked tree's names ("layers/wq"; the
    leading dim is the layer axis)."""
    t = tp_axis
    rules = [
        (r"^embed$", P()),
        (r"^head$", P()),
        # every norm leaf: ln1_*/ln2_* in layers, lnf_* at the root
        (r"(^|/)ln[0-9a-z]*_(scale|bias)$", P()),
        (r"(^|/)w[qkv]$", P(None, None, t)),
        (r"(^|/)wo$", P(None, t, None)),
    ]
    if n_experts:
        ep = ep_axis
        rules += [
            (r"(^|/)wr$", P()),
            (r"(^|/)w1$", P(None, ep, None, t)),
            (r"(^|/)b1$", P(None, ep, t)),
            (r"(^|/)w2$", P(None, ep, t, None)),
            (r"(^|/)b2$", P(None, ep, None)),
        ]
    else:
        rules += [
            (r"(^|/)w1$", P(None, None, t)),
            (r"(^|/)b1$", P(None, t)),
            (r"(^|/)w2$", P(None, t, None)),
            (r"(^|/)b2$", P()),
        ]
    return rules


# --------------------------------------------------- rules-file (de)serde


def spec_to_json(spec) -> list:
    """One spec as a JSON list (tuple entries become lists)."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def spec_from_json(entries) -> P:
    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])


def rules_to_json(rules) -> list:
    """[[pattern, spec-entries], ...]: the ``--sharding rules:<file>`` document."""
    return [[pattern, spec_to_json(spec)] for pattern, spec in rules]


def rules_from_json(doc) -> list:
    if not isinstance(doc, list):
        raise ValueError(f"a rules document is a JSON list of [pattern, spec] pairs, got "
                         f"{type(doc).__name__}")
    rules = []
    for i, entry in enumerate(doc):
        if (not isinstance(entry, (list, tuple)) or len(entry) != 2
                or not isinstance(entry[0], str) or not isinstance(entry[1], list)):
            raise ValueError(f"rules entry {i} must be [pattern, [spec entries...]], got "
                             f"{entry!r}")
        pattern, spec = entry
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(f"rules entry {i}: pattern {pattern!r} is not a valid regex: "
                             f"{e}") from None
        rules.append((pattern, spec_from_json(spec)))
    return rules


def save_rules(rules, path: str) -> str:
    with open(path, "w") as f:
        json.dump(rules_to_json(rules), f, indent=2)
        f.write("\n")
    return path


def load_rules(path: str) -> list:
    """Parse a ``--sharding rules:<file>`` JSON document into rule pairs,
    with file and parse errors naming the path."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"rules file {path!r} does not exist (--sharding rules:<file> expects a JSON "
            "list of [pattern, spec] pairs; write one with parallel/rules.py save_rules)"
        ) from None
    except json.JSONDecodeError as e:
        raise ValueError(f"rules file {path!r} is not valid JSON: {e}") from None
    try:
        return rules_from_json(doc)
    except ValueError as e:
        raise ValueError(f"rules file {path!r}: {e}") from None


def format_rules(rules) -> str:
    """One rule per line, for error context."""
    width = max((len(p) for p, _ in rules), default=0)
    return "\n".join(f"  {pattern:<{width}}  ->  {spec}" for pattern, spec in rules)
