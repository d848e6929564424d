"""Filtered search: predicate-aware BQ navigation.

Counterpart of ``repro/filter``.  Public surface:

* :class:`LabelStore` — packed per-node label bitsets on the index's
  device, with per-label entry points;
* :class:`Any` / :class:`All` / :class:`Not` — label predicates, evaluated
  to bool masks over the packed words;
* selectivity routing helpers (``estimate_selectivity``, ``route``,
  ``widened_ef``, ``brute_force_topk``, ``build_label_entries``).

A ``filter=`` predicate reaches the two-mask beam search of
``repro_torch.core.beam``: ``node_valid`` (tombstones, traversed but never
returned) and ``result_valid`` (the predicate mask) restrict what may be
*returned*, never what may be *traversed*.
"""

from repro_torch.filter.labels import (
    LabelStore,
    n_label_words,
    pack_label_rows,
)
from repro_torch.filter.predicate import (
    All,
    Any,
    Label,
    Not,
    Predicate,
    as_predicate,
    entry_label,
    estimate_selectivity,
    eval_mask,
    labels_in,
    validate,
)
from repro_torch.filter.search import (
    DEFAULT_SELECTIVITY_FLOOR,
    brute_force_topk,
    build_label_entries,
    route,
    widened_ef,
)

__all__ = [
    "All",
    "Any",
    "DEFAULT_SELECTIVITY_FLOOR",
    "Label",
    "LabelStore",
    "Not",
    "Predicate",
    "as_predicate",
    "brute_force_topk",
    "build_label_entries",
    "entry_label",
    "estimate_selectivity",
    "eval_mask",
    "labels_in",
    "n_label_words",
    "pack_label_rows",
    "route",
    "validate",
    "widened_ef",
]
