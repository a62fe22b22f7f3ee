"""Two-key lexicographic sort — torch's counterpart of
``lax.sort(operands, num_keys=2, is_stable=True)``.

The JAX package orders every candidate list by ``(distance, pid)``, the
reference's ``Candidate`` order (types.rs:229-234), and groups reverse
edges by ``(target, distance)``.  Torch sorts on one key only, so the
helper sorts stably by the secondary key and then stably by the primary
key: the second pass keeps the first pass's order among equal primary
keys, which is exactly lexicographic order, with full ties left in their
input order.
"""

from __future__ import annotations

import torch


def argsort2(primary, secondary, dim: int = -1):
    """Permutation sorting by ``(primary, secondary)`` along ``dim``,
    stable on full ties."""
    _, by_second = torch.sort(secondary, dim=dim, stable=True)
    _, by_first = torch.sort(primary.gather(dim, by_second), dim=dim,
                             stable=True)
    return by_second.gather(dim, by_first)


def sort2(primary, secondary, *payload, dim: int = -1):
    """Sort ``(primary, secondary, *payload)`` by the first two; returns
    the permuted tensors in the order given."""
    order = argsort2(primary, secondary, dim)
    return tuple(x.gather(dim, order)
                 for x in (primary, secondary) + payload)
