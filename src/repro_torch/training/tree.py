"""Pytrees of tensors: the port's params, gradients and optimizer state.

Dicts (keys sorted, as JAX flattens them), lists and tuples (NamedTuples
included) in order; anything else is a leaf. `None` is a leaf too: a
gradient that no loss reached."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in flattening order; a path is the keys and indices
    from the root."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(template, flat: List[Any]):
    """`template`'s structure with its leaves replaced, in order, by
    `flat`."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}       # the template's key order
        if isinstance(t, (list, tuple)):
            items = [build(v) for v in t]
            if hasattr(t, "_fields"):           # a NamedTuple
                return type(t)(*items)
            return type(t)(items)
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def structure(tree) -> str:
    """A printable description of the structure (leaves as '*')."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(structure(v) for v in tree)
        name = type(tree).__name__ if hasattr(tree, "_fields") else ""
        return f"{name}[{inner}]"
    return "*"
