"""Row buckets and stacked operands for arrays of datasets on one device
(counterpart of ``bucket_rows`` and ``stack_trees`` in
``pint_tpu/fitting/batch.py``).

Ragged TOA counts are padded up to a power-of-two bucket of rows whose pad
rows carry weight zero, so that every member of an array (the pulsars of a
PTA) shares one shape and the members stack along a leading axis. The JAX
package's fleet fits, its per-slot stack memo and buffer donation
(``placed_stack``, ``fleet_restack``) are not ported (ROADMAP A11b).
"""

from __future__ import annotations

import torch

#: the smallest row bucket (pint_tpu MIN_BUCKET_ROWS)
MIN_BUCKET_ROWS = 16


def bucket_rows(n_data: int) -> int:
    """The padded data rows of one dataset: the next power of two >= n_data,
    at least MIN_BUCKET_ROWS."""
    b = MIN_BUCKET_ROWS
    while b < n_data:
        b *= 2
    return b


def stack_trees(trees):
    """Stack structurally identical trees (dicts, tuples and lists of
    tensors) along a new leading axis; a None leaf stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_trees(list(xs)) for xs in zip(*trees))
    return torch.stack([torch.as_tensor(t) for t in trees])
