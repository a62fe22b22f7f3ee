"""The fused graph walk, kernel K4 (port of ``walk_search`` in
``instant_distance_tpu/ops/walk_kernel.py``).

One call runs the whole zero-layer packed beam search of a query batch:
each step picks the first ``expand`` unexpanded entries of every beam,
reads their packed rows (``ids [N, K]``, ``codes [N, K, D]``, ``scales
[N, K]``, the ``zero_pack`` of ``ops/packed.py``), scores the neighbours
by int8-dequantized squared L2, drops neighbours already in the beam or
repeated from an earlier expansion of the same step, and merges them
into the new top-``ef`` by the strict order (dist, pid, position).  A
query stops once no unexpanded entry is left, or at ``max_iters``.
Distances are ``ops.packed.approx_dists``, whose D-term sum has the
kernel's fixed order.

Semantics are ``beam_search_packed``'s (``ops/packed.py``) on valid
graphs, whose adjacency rows hold distinct pids (``utils/validate.py``
of the JAX package): like the TPU kernel, the walk does not dedup inside
one row.

:func:`walk_search` launches the CUDA kernel (``csrc/walk_kernel.cu``:
one thread block a query, each step's rows staged into shared memory by
``cp.async``, a merge by ranks) on CUDA tensors and counts the launch in
``launches["walk_search"]``; on CPU tensors it runs
:func:`walk_search_plain`.  The JAX package's two merge strategies,
``"count"`` and ``"extract"``, define one beam; both names are accepted
and run the one kernel.  Left out of the port: the TPU layouts
``pack_walk_meta``/``pack_walk_fused`` (DMA issue cost on the TPU's
scalar core; the card reads the three arrays as they are) and the
``bq``/``fused_rows``/``k`` knobs.
"""

from __future__ import annotations

import torch

from .beam import chosen_slots
from .packed import approx_dists
from .scan_kernel import _launch, _on_card, _ptr
from .sort import sort2

#: Largest beam the kernel keeps in shared memory, its expand widths,
#: and its largest candidate pool a step (expand * K).
MAX_EF = 256
EXPANDS = (1, 2)
MAX_POOL = 4096
#: The JAX package's merge strategies; one beam, one kernel.
MERGES = ("count", "extract")
#: Bytes of codes a block stages at once (>= 4096; a step's rows past
#: it are staged in chunks).
STAGE_BYTES = 20480


def _check(queries, beam_d0, beam_p0, ids, codes, scales, expand: int,
           ef: int, merge: str) -> None:
    for name, t, dtype, dim in (("queries", queries, torch.float32, 2),
                                ("beam_d0", beam_d0, torch.float32, 2),
                                ("beam_p0", beam_p0, torch.int32, 2),
                                ("ids", ids, torch.int32, 2),
                                ("codes", codes, torch.int8, 3),
                                ("scales", scales, torch.float32, 2)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D, got {tuple(t.shape)}")
    b, d = queries.shape
    n, k, dc = codes.shape
    if dc != d or tuple(ids.shape) != (n, k) \
            or tuple(scales.shape) != (n, k):
        raise ValueError(f"shape mismatch: queries {tuple(queries.shape)}, "
                         f"ids {tuple(ids.shape)}, codes "
                         f"{tuple(codes.shape)}, scales "
                         f"{tuple(scales.shape)}")
    if tuple(beam_d0.shape) != (b, ef) or tuple(beam_p0.shape) != (b, ef):
        raise ValueError(f"beams must be [B, ef] = [{b}, {ef}], got "
                         f"{tuple(beam_d0.shape)} / {tuple(beam_p0.shape)}")
    if not 1 <= ef <= MAX_EF:
        raise ValueError(f"ef must be in [1, {MAX_EF}], got {ef}")
    if expand not in EXPANDS:
        raise ValueError(f"expand must be one of {EXPANDS}, got {expand}")
    if expand * k > MAX_POOL:
        raise ValueError(f"expand * K = {expand * k} > {MAX_POOL}")
    if merge not in MERGES:
        raise ValueError(f"merge must be one of {MERGES}, got {merge!r}")


def walk_search_plain(queries, beam_d0, beam_p0, ids, codes, scales, *,
                      expand: int = 2, ef: int = 16, max_iters: int = 144,
                      merge: str = "count", return_work: bool = False):
    """Plain torch version of :func:`walk_search`: the same steps over the
    whole batch at once (a converged query's step changes nothing), the
    merge as one stable (dist, pid) sort, the order both of the JAX
    package's merge strategies produce.  With ``return_work`` it also
    returns the work over all queries that K4's bound counts: the rows
    expanded (each read's K ids) and the valid neighbours in them (each
    one's D codes and scale)."""
    _check(queries, beam_d0, beam_p0, ids, codes, scales, expand, ef, merge)
    b = queries.shape[0]
    k = ids.shape[1]
    ek = expand * k
    group = torch.arange(ek, device=queries.device) // k
    # earlier[c, c2]: candidate c2 comes from an earlier row than c
    earlier = group[None, :] < group[:, None]
    bd, bp = beam_d0, beam_p0
    be = torch.zeros_like(bp, dtype=torch.bool)
    expansions = torch.zeros((), dtype=torch.int64, device=queries.device)
    scored = torch.zeros((), dtype=torch.int64, device=queries.device)
    for _ in range(max_iters):
        if not bool(((bp >= 0) & ~be).any()):
            break
        chosen, cur = chosen_slots(bp, be, expand)
        expansions += chosen.sum()
        be = be | chosen
        safe = cur.clamp(min=0).long()                  # [B, E]
        nb = ids[safe].view(b, ek)
        nd = approx_dists(queries, codes[safe].view(b, ek, -1),
                          scales[safe].view(b, ek))
        valid = (nb >= 0) & (cur >= 0).repeat_interleave(k, dim=1)
        scored += valid.sum()
        nb = torch.where(valid, nb, -1)
        nd = torch.where(valid, nd, torch.inf)
        dup = ((nb[:, :, None] == bp[:, None, :])
               & (bp >= 0)[:, None, :]).any(2)
        if expand > 1:
            dup |= ((nb[:, :, None] == nb[:, None, :])
                    & (nb >= 0)[:, None, :] & earlier).any(2)
        nd = torch.where(dup, torch.inf, nd)
        nb = torch.where(dup, -1, nb)
        bd, bp, be = sort2(torch.cat([bd, nd], 1), torch.cat([bp, nb], 1),
                           torch.cat([be, torch.zeros_like(dup)], 1))
        bd, bp, be = bd[:, :ef], bp[:, :ef], be[:, :ef]
    if return_work:
        return bd, bp, int(expansions), int(scored)
    return bd, bp


def walk_search(queries, beam_d0, beam_p0, ids, codes, scales, *,
                expand: int = 2, ef: int = 16, max_iters: int = 144,
                merge: str = "count"):
    """Fused packed-graph beam search (approximate distances, no rerank).

    Args:
      queries: [B, D] f32.
      beam_d0/beam_p0: [B, ef] f32 / int32 initial beams (the seed scan's
        output in the leading slots, (+inf, -1) after it).
      ids, codes, scales: the packed zero layer, [N, K] int32, [N, K, D]
        int8 and [N, K] f32.
      expand: beam entries expanded per step, 1 or 2.
      merge: "count" or "extract", the JAX package's merge strategies,
        which define the same beam: both launch the one kernel.
    Returns (bd [B, ef] f32 approximate distances, bp [B, ef] int32),
    sorted by (dist, pid).  Requires ef <= 256.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    tensors = (queries, beam_d0, beam_p0, ids, codes, scales)
    if not _on_card(tensors):
        return walk_search_plain(queries, beam_d0, beam_p0, ids, codes,
                                 scales, expand=expand, ef=ef,
                                 max_iters=max_iters, merge=merge)
    _check(queries, beam_d0, beam_p0, ids, codes, scales, expand, ef, merge)
    b, d = queries.shape
    k = ids.shape[1]
    dev = queries.device
    bd = torch.empty((b, ef), dtype=torch.float32, device=dev)
    bp = torch.empty((b, ef), dtype=torch.int32, device=dev)
    if b:
        _launch("walk_search", "idt_walk_search", dev, _ptr(queries),
                _ptr(beam_d0), _ptr(beam_p0), _ptr(ids), _ptr(codes),
                _ptr(scales), _ptr(bd), _ptr(bp), b, d, k, ef, expand,
                max_iters, STAGE_BYTES)
    return bd, bp


def block_shape(d: int, k: int, ef: int, expand: int):
    """(dynamic shared memory bytes of one K4 block, blocks an SM holds
    at once) at this shape with :data:`STAGE_BYTES`; needs the card
    (builds the kernels on first use)."""
    from ._build import library

    lib = library()
    return (lib.idt_walk_smem(d, k, ef, expand, STAGE_BYTES),
            lib.idt_walk_occupancy(d, k, ef, expand, STAGE_BYTES))
