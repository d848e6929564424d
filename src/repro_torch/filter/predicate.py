"""Label predicates: Any/All/Not expressions evaluated over packed bitsets.

Counterpart of ``repro/filter/predicate.py``.  A predicate is a small
immutable expression tree over integer label ids (``Any``/``All``/``Not``,
leaves are labels).  :func:`eval_mask` turns one into an ``(n,)`` bool mask
from the packed ``(n, W)`` label words of a
:class:`repro_torch.filter.labels.LabelStore`: a few shift/AND/OR word
operations on the words' device, run eagerly (the reference jit-compiles
one program per expression shape; nothing is compiled here).

The words are int32 bit views of the reference's uint32 words, as the
signatures are.  ``>>`` on int32 is an arithmetic shift, so bit 31 comes
back as -1 or 0; the ``& 1`` after it is what keeps that bit right.

Selectivity estimation (:func:`estimate_selectivity`) never touches the
mask: it works from per-label popcounts by the classic bounds (union bound
for ``Any``, min for ``All``, complement for ``Not``) and drives the
graph-vs-brute-force routing.  :func:`entry_label` picks the label whose
per-label entry point a filtered traversal should start from.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Union

import torch


class Predicate:
    """Base class for label expressions (see ``Any``/``All``/``Not``)."""

    __slots__ = ()


PredicateLike = Union[Predicate, int]


@dataclasses.dataclass(frozen=True)
class Label(Predicate):
    """Leaf: node carries label ``label``."""

    label: int


def as_predicate(expr: PredicateLike) -> Predicate:
    """Coerce a bare label id to a :class:`Label` leaf."""
    if isinstance(expr, Predicate):
        return expr
    if isinstance(expr, int) and not isinstance(expr, bool):
        return Label(int(expr))
    raise TypeError(
        f"predicate must be Any/All/Not/Label or an int label id, "
        f"got {type(expr).__name__}"
    )


@dataclasses.dataclass(frozen=True, init=False)
class Any(Predicate):
    """Union: node carries at least one of the given labels/sub-exprs."""

    items: tuple[Predicate, ...]

    def __init__(self, *items: PredicateLike):
        if not items:
            raise ValueError("Any() needs at least one label")
        object.__setattr__(
            self, "items", tuple(as_predicate(i) for i in items)
        )


@dataclasses.dataclass(frozen=True, init=False)
class All(Predicate):
    """Intersection: node carries every given label/sub-expr."""

    items: tuple[Predicate, ...]

    def __init__(self, *items: PredicateLike):
        if not items:
            raise ValueError("All() needs at least one label")
        object.__setattr__(
            self, "items", tuple(as_predicate(i) for i in items)
        )


@dataclasses.dataclass(frozen=True, init=False)
class Not(Predicate):
    """Complement of a single label/sub-expr."""

    expr: Predicate

    def __init__(self, expr: PredicateLike):
        object.__setattr__(self, "expr", as_predicate(expr))


def labels_in(expr: PredicateLike) -> set[int]:
    """All label ids referenced anywhere in ``expr``."""
    expr = as_predicate(expr)
    if isinstance(expr, Label):
        return {expr.label}
    if isinstance(expr, (Any, All)):
        out: set[int] = set()
        for item in expr.items:
            out |= labels_in(item)
        return out
    assert isinstance(expr, Not)
    return labels_in(expr.expr)


# ---------------------------------------------------------------------------
# evaluation: expression -> (n,) bool mask over packed words
# ---------------------------------------------------------------------------


def _member_bits(words: torch.Tensor, label: int) -> torch.Tensor:
    w, b = divmod(label, 32)
    return ((words[..., w] >> b) & 1) != 0


def _eval(words: torch.Tensor, expr: Predicate) -> torch.Tensor:
    if isinstance(expr, Label):
        return _member_bits(words, expr.label)
    if isinstance(expr, Any):
        return functools.reduce(
            torch.logical_or, (_eval(words, i) for i in expr.items)
        )
    if isinstance(expr, All):
        return functools.reduce(
            torch.logical_and, (_eval(words, i) for i in expr.items)
        )
    assert isinstance(expr, Not)
    return ~_eval(words, expr.expr)


def eval_mask(words: torch.Tensor, expr: PredicateLike) -> torch.Tensor:
    """Packed int32 label words ``(..., W)`` -> ``(...,)`` bool match mask,
    on the words' device."""
    return _eval(words, as_predicate(expr))


def validate(expr: PredicateLike, n_labels: int) -> Predicate:
    """Coerce + bounds-check every referenced label id."""
    expr = as_predicate(expr)
    bad = [lb for lb in labels_in(expr) if not 0 <= lb < n_labels]
    if bad:
        raise ValueError(
            f"predicate references labels {sorted(bad)} outside "
            f"[0, {n_labels})"
        )
    return expr


# ---------------------------------------------------------------------------
# selectivity estimation + entry-point routing (from label popcounts)
# ---------------------------------------------------------------------------

CountFn = Callable[[int], int]


def estimate_selectivity(
    expr: PredicateLike, count_fn: CountFn, n: int
) -> float:
    """Estimated match fraction of ``expr`` over ``n`` nodes.

    Pure popcount arithmetic (no mask evaluation): union bound for
    ``Any``, min for ``All``, complement for ``Not``.  Overestimating
    selectivity widens ``ef`` less; the brute route re-checks an estimate
    below the floor against the exact mask popcount.
    """
    if n <= 0:
        return 0.0
    expr = as_predicate(expr)
    if isinstance(expr, Label):
        return min(1.0, count_fn(expr.label) / n)
    if isinstance(expr, Any):
        return min(
            1.0,
            sum(estimate_selectivity(i, count_fn, n) for i in expr.items),
        )
    if isinstance(expr, All):
        return min(
            estimate_selectivity(i, count_fn, n) for i in expr.items
        )
    assert isinstance(expr, Not)
    return 1.0 - estimate_selectivity(expr.expr, count_fn, n)


def entry_label(expr: PredicateLike, count_fn: CountFn) -> int | None:
    """The label whose per-label entry point a filtered search should
    start from, or ``None`` when the predicate carries no positive label
    information (e.g. a bare ``Not``).

    ``All``: the most selective positively-required label, whose region is
    the tightest superset of the match set.  ``Any``: the most populous
    branch, the largest reachable slice of the union.
    """
    expr = as_predicate(expr)
    if isinstance(expr, Label):
        return expr.label
    if isinstance(expr, Not):
        return None
    cands = [entry_label(i, count_fn) for i in expr.items]
    cands = [c for c in cands if c is not None]
    if not cands:
        return None
    if isinstance(expr, All):
        return min(cands, key=count_fn)
    return max(cands, key=count_fn)
