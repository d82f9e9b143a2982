"""Nested dicts and lists of tensors — the port's parameter and train-state
trees — walked in the JAX package's leaf order (dict keys sorted, lists in
order), so that sums over leaves and checkpoint manifests line up with the
reference's ``jax.tree`` functions."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Mapping, Tuple

Path = Tuple[str, ...]


def leaves_with_path(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(like: Any, flat: List[Any]) -> Any:
    """The inverse of :func:`leaves`: ``flat`` placed into ``like``'s
    structure."""
    it = iter(flat)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def subtree(tree: Any, path: Path) -> Any:
    """The node of ``tree`` at ``path`` (a path of :func:`leaves_with_path`);
    what lies there may itself be a list, such as a DTensor's placements."""
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree
