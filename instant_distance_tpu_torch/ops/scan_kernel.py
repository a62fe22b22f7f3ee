"""The int8 scan kernels (ports of K1, K2, K3 and K5 of
``instant_distance_tpu/ops/scan_kernel.py``), their operands and the
packed-key format.

Each kernel multiplies a query batch of int8 codes by every point's int8
codes and reduces the products in the same pass to one result per
``lsub``-wide stride group: group o of a ``cb``-point block holds the
points ``p = (o // ct) * cb + t * ct + o % ct`` for t < lsub, ct = cb // lsub.

* K1 :func:`fused_scan_bucket_int_packed`: packed int32 keys
  ``min_t (w2[p] - dot * lsub)``.  ``w2`` (:func:`pack_w2`) packs the
  point's rank weight with its slab index in the low bits, so the key
  also says which point won (:func:`decode_keys`).  The wave build and
  ``ScanIndex(fused="bucket_pack")`` take their operands from
  :func:`pack_operands` and :func:`quantize_batch`.
* K2 :func:`fused_scan_bucket`: per-point scales; f32 distances
  ``norms - 2 * (qs * s) * dot`` (L2) or ``bias - (qs * s) * dot``
  (dot/cosine), their min and argmin per group.
* K3 :func:`fused_scan_bucket_int`: shared scales; int32 ranks
  ``w - dot``, their min and argmin per group.
* K5 :func:`fused_scan_topt`: K2's group minima, then the ``topt`` best
  of each cb block per query.
* K6 :func:`fused_scan_probe`: K1 cut short for timing (``mm``: the
  product alone, ``min``: the min chain over the raw dot, ``full``: K1's
  keys), so the three times split K1's into its stages.

Each wrapper launches its hand-written CUDA kernel (``csrc/``) on CUDA
tensors and counts the launch in :data:`launches`; on CPU tensors it
runs the plain torch version beside it (``*_plain``), which agrees with
the kernel bit for bit.  It never falls back from one to the other.

K1, K2, K3, K5 and K6 run on the Hopper tile of ``csrc/wgmma_tile.cuh``,
whose TMA copies read the codes point-major: :func:`point_major` keeps
that copy of ``codes_t`` ([Npad, Dpad], Dpad = D rounded up to 32 with
zero codes) beside the tensor, made once (by the operand builders on the
card, else at the first launch) and reused by every later call on the
same ``codes_t``.  The wrappers pad the batch's ``qc`` to Dpad the same
way.
"""

from __future__ import annotations

import torch

_I32MAX = 2**31 - 1

#: Packed-key constants, as in the JAX package: real keys lie in
#: [2^23, 9*2^27), keys of groups with no eligible point at or above
#: PACK_THRESH (see instant_distance_tpu/ops/scan_kernel.py:252-268).
PACK_INELIGIBLE = 3 << 29
PACK_THRESH = 9 << 27
PACK_OFFSET = 1 << 23

#: Kernel launches so far, per wrapper (CUDA only; the plain versions do
#: not count).  ``walk_search`` is K4's (``ops/walk_kernel.py``).
launches = {"fused_scan_bucket_int_packed": 0, "fused_scan_bucket": 0,
            "fused_scan_bucket_int": 0, "fused_scan_topt": 0,
            "walk_search": 0, "fused_scan_probe": 0}
#: Point-major copies made by :func:`point_major` (at most one per
#: ``codes_t`` tensor and change of it).
point_major_copies = 0
#: The Hopper tile's query block and column tile (csrc/wgmma_tile.cuh's
#: kBQ, kBN): a launch has ceil(B / 128) x N / cb x ceil(cb / lsub / 128)
#: blocks.
_TILE_Q, _TILE_N = 128, 128
#: K3's ids are -1 where the group's rank is at least this (the JAX
#: kernel's ``big // 2``, big = INT32_MAX // 2).
INT_RANK_LIMIT = (_I32MAX // 2) // 2


def pack_w2(norms_row, denom, eligible_row, *, lsub: int, cb: int,
            d: int):
    """Packed-weight operand [1, N] int32 for the packed-key scan.

    ``(clamp(round(norms/denom), 0, 2^29/lsub - 1) + 127^2*d) * lsub
    + slab(col) + 2^23`` for eligible points (finite norm and
    ``eligible_row``), else PACK_INELIGIBLE.  ``norms_row`` is [1, N]
    f32 (non-finite marks padding), ``denom`` the f32 scalar
    ``2 * qs * s``, ``eligible_row`` a [1, N] bool or None.
    """
    bias = 127 * 127 * d
    wclamp = (1 << 29) // lsub - 1
    fin = torch.isfinite(norms_row)
    w = torch.where(fin, torch.clamp(torch.round(norms_row / denom), 0,
                                     wclamp), 0).to(torch.int32)
    ct = cb // lsub
    col = torch.arange(norms_row.shape[1], dtype=torch.int32,
                       device=norms_row.device)[None, :]
    w2 = (w + bias) * lsub + (col % cb) // ct + PACK_OFFSET
    ok = fin if eligible_row is None else (fin & eligible_row)
    return torch.where(ok, w2, PACK_INELIGIBLE)


def padded_width(d: int) -> int:
    """Dpad: the d bytes of a row of the point-major codes and of the
    padded queries, D rounded up to 32 (TMA wants 16-byte row strides)."""
    return -(-d // 32) * 32


def point_major(codes_t, codes=None):
    """The point-major codes [Npad, Dpad] int8 of ``codes_t`` [D, Npad]:
    ``codes_t.T`` with zero codes in columns D..Dpad-1, which change no
    dot product.  K1-K3 read this copy on the card.  It is made once and
    kept on ``codes_t`` (remade only after an in-place change of it);
    ``codes`` [N <= Npad, D], the rows ``codes_t`` was transposed from,
    makes it without the strided transpose."""
    global point_major_copies
    # an inference tensor has no version counter, and cannot change
    # outside inference mode
    version = None if codes_t.is_inference() else codes_t._version
    kept = getattr(codes_t, "_point_major", None)
    if kept is not None and kept[0] == version:
        return kept[1]
    d, npad = codes_t.shape
    pm = torch.zeros((npad, padded_width(d)), dtype=torch.int8,
                     device=codes_t.device)
    if codes is None:
        pm[:, :d] = codes_t.T
    else:
        pm[:codes.shape[0], :d] = codes
    codes_t._point_major = (version, pm)
    point_major_copies += 1
    return pm


def _queries_for_tile(qc, dpad: int):
    """The batch's codes as the Hopper tile's TMA reads them: [B, dpad],
    16-byte aligned, zero past D (a copy unless ``qc`` is already so)."""
    b, d = qc.shape
    if d == dpad and qc.data_ptr() % 16 == 0:
        return qc
    out = torch.zeros((b, dpad), dtype=torch.int8, device=qc.device)
    out[:, :d] = qc
    return out


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (TMA
    reads whole 16-byte words)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_tile(b: int, d: int, n: int, lsub: int, cb: int) -> None:
    """Shapes the Hopper tile cannot take raise before the launch: no d
    bytes, more than 2^16 slabs (K2, K3 and K5 keep each argmin slab in
    16 bits), or a grid past 2^31 - 1 blocks."""
    if d < 1:
        raise ValueError("the scan kernels need D >= 1")
    if lsub > 1 << 16:
        raise ValueError(f"lsub = {lsub} > 65536: the kernels' argmin "
                         "slabs are 16-bit")
    blocks = (-(-b // _TILE_Q) * (n // cb)
              * -(-(cb // lsub) // _TILE_N))
    if blocks > 2**31 - 1:
        raise ValueError(f"B={b}, N={n}, lsub={lsub}, cb={cb} needs {blocks}"
                         " blocks, more than one launch holds")


def _tile_args(qc, codes_t, lsub: int, cb: int):
    """(queries, point-major codes, Dpad) of a launch on the Hopper tile,
    after the tile's shape checks."""
    b, d = qc.shape
    _check_tile(b, d, codes_t.shape[1], lsub, cb)
    dpad = padded_width(d)
    return _queries_for_tile(qc, dpad), point_major(codes_t), dpad


def pack_operands(points, cb: int, real=None):
    """Point-side operands of the packed-key scan over ``points`` [N, D]
    f32: ONE global scale ``sg``, the codes transposed to [D, Npad] int8
    and the dequantized squared norms [1, Npad] with +inf padding, Npad
    the next multiple of ``cb``.  ``real`` (bool [N], default all) marks
    the rows that are points: only they set ``sg``.  Returns (codes_t,
    norms_r, sg); on the card ``codes_t`` keeps its :func:`point_major`
    copy."""
    amax = (points.abs() if real is None
            else torch.where(real[:, None], points.abs(), 0.0)).max()
    sg = torch.clamp(amax, min=1e-30) / 127.0
    codes = torch.clamp(torch.round(points / sg), -127, 127).to(torch.int8)
    deq = codes.float() * sg
    norms = (deq * deq).sum(1)
    npad = (-points.shape[0]) % cb
    codes_t = torch.nn.functional.pad(codes, (0, 0, 0, npad)).T.contiguous()
    if codes_t.is_cuda:
        point_major(codes_t, codes)
    norms_r = torch.nn.functional.pad(norms, (0, npad),
                                      value=torch.inf)[None, :]
    return codes_t, norms_r, sg


def bucket_operands(codes, scales, norms, cb: int, variant: str):
    """Point-side operands of K2/K5 from per-point int8 ``codes`` [N, D],
    their ``scales`` [N] and dequantized squared norms [N]: the codes
    transposed to [D, Npad] int8, scales [1, Npad] and norms [1, Npad]
    with +inf padding, Npad the next multiple of ``cb``.  ``variant``:

    * ``"l2"``:     norms are |p_hat|^2 (dist = |p|^2 - 2 q.p);
    * ``"dot"``:    norms are the 0 eligibility bias (dist = bias - q.p);
    * ``"cosine"``: as "dot", with 1/|p_hat| folded into the scales.

    Returns (codes_t, scales_r, norms_r); on the card ``codes_t`` keeps
    its :func:`point_major` copy."""
    n = codes.shape[0]
    npad = (-n) % cb
    codes_t = torch.nn.functional.pad(codes, (0, 0, 0, npad)).T.contiguous()
    if codes_t.is_cuda:
        point_major(codes_t, codes)
    if variant == "cosine":
        scales = scales * torch.rsqrt(torch.clamp(norms, min=1e-30))
    scales_r = torch.nn.functional.pad(scales, (0, npad))[None, :]
    base = norms if variant == "l2" else torch.zeros_like(norms)
    norms_r = torch.nn.functional.pad(base, (0, npad),
                                      value=torch.inf)[None, :]
    return codes_t, scales_r, norms_r


def bucket_queries(queries, metric_name: str):
    """Query-side operands of K2/K5: per-query int8 codes [B, D] and
    scales [B, 1] (the scheme of ``quantize_points``); cosine divides
    each scale by |q|, so with :func:`bucket_operands`' cosine scales the
    kernel's product is the cosine itself.  Returns (qc, qs)."""
    amax = queries.abs().amax(dim=-1, keepdim=True)
    qs = torch.clamp(amax, min=1e-30) / 127.0
    qc = torch.clamp(torch.round(queries / qs), -127, 127).to(torch.int8)
    if metric_name == "cosine":
        qn = torch.sqrt((queries * queries).sum(1, keepdim=True))
        qs = qs / torch.clamp(qn, min=1e-30)
    return qc, qs


def quantize_batch(queries):
    """Query-side operand: int8 codes [B, D] under ONE scale ``qs`` shared
    by the whole batch (the packed keys compare across queries' rows only
    through ``denom = 2 * qs * sg``).  Returns (qc, qs)."""
    qs = torch.clamp(queries.abs().max(), min=1e-30) / 127.0
    qc = torch.clamp(torch.round(queries / qs), -127, 127).to(torch.int8)
    return qc, qs


def decode_keys(keys, cols, *, lsub: int, cb: int):
    """Point ids [.., K] int32 of packed ``keys`` read at key columns
    ``cols``; -1 where the key is a group with no eligible point."""
    ct = cb // lsub
    ids = (cols // ct) * cb + (keys & (lsub - 1)) * ct + cols % ct
    return torch.where(keys < PACK_THRESH, ids, -1).to(torch.int32)


def int8_matmul(a, b):
    """Exact int32 product of int8 matrices ``a [M, K] @ b [K, N]``.

    CUDA has no int32 matmul.  There a float matmul of the int8 values
    is exact while every partial sum is an integer below the mantissa
    limit: |sum| <= 127^2 * K < 2^24 for K <= 1040 in f32 (TF32 is off
    package-wide), and f64 covers larger K.  The CPU multiplies in int32.
    """
    if a.is_cuda:
        k = a.shape[-1]
        ft = torch.float32 if 127 * 127 * k < (1 << 24) else torch.float64
        return (a.to(ft) @ b.to(ft)).to(torch.int32)
    return a.to(torch.int32) @ b.to(torch.int32)


def _check_operands(qc, codes_t, **rows) -> None:
    """Common operand checks: int8 ``qc [B, D]`` and ``codes_t [D, N]``,
    and each of ``rows`` (name -> (tensor, dtype, "B" or "N")) a [B, 1]
    or [1, N] tensor of its dtype."""
    if qc.dtype != torch.int8 or codes_t.dtype != torch.int8:
        raise TypeError(f"qc and codes_t must be int8, got {qc.dtype}/"
                        f"{codes_t.dtype}")
    if qc.dim() != 2 or codes_t.dim() != 2:
        raise ValueError("qc must be [B, D] and codes_t [D, N]")
    b, d = qc.shape
    n = codes_t.shape[1]
    if codes_t.shape[0] != d:
        raise ValueError(f"shape mismatch: qc {tuple(qc.shape)}, codes_t "
                         f"{tuple(codes_t.shape)}")
    for name, (t, dtype, axis) in rows.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        want = (b, 1) if axis == "B" else (1, n)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got "
                             f"{list(t.shape)}")


def _check_blocks(n: int, lsub: int, cb: int) -> None:
    if lsub < 1 or cb % lsub or n % cb:
        raise ValueError(f"need lsub | cb | N, got lsub={lsub} cb={cb} N={n}")
    if n >= 2**31:
        raise ValueError("point ids must fit in int32")


def _check(qc, w2, codes_t, lsub: int, cb: int, groups: int) -> None:
    _check_operands(qc, codes_t, w2=(w2, torch.int32, "N"))
    d = qc.shape[1]
    if lsub < 1 or lsub & (lsub - 1):
        raise ValueError(f"lsub must be a power of two, got {lsub}")
    if d * lsub > 16384:
        raise ValueError(f"D*lsub = {d * lsub} > 16384: packed keys could "
                         "overflow")
    _check_blocks(codes_t.shape[1], lsub, cb)
    ct = cb // lsub
    if groups > 1 and (groups & (groups - 1) or ct % groups):
        raise ValueError(f"groups must be a power of two dividing "
                         f"cb/lsub = {ct}, got {groups}")


def _on_card(tensors) -> bool:
    """False when every operand lies on the CPU (the plain version
    runs); True for contiguous operands on one CUDA device (the kernel
    runs); anything else raises."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the operands must share one CUDA device (or all "
                         f"be on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the scan kernels need contiguous operands")
    return True


def _launch(name: str, entry: str, dev, *args) -> None:
    """Call the C launcher ``entry`` on ``dev``'s current stream, raise on
    a launch error, and count the launch for wrapper ``name`` (one a
    call, whatever number of kernels the launcher starts)."""
    from ._build import check, library

    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    check(lib, rc, name)
    launches[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K1: packed keys
# ---------------------------------------------------------------------------

def fused_scan_bucket_int_packed_plain(qc, w2, codes_t, *, lsub: int,
                                       cb: int, groups: int = 0):
    """Plain torch version: the whole [B, N] key matrix, then the two
    strided mins as reshapes.  Same arguments and results as
    :func:`fused_scan_bucket_int_packed`."""
    _check(qc, w2, codes_t, lsub, cb, groups)
    b, d = qc.shape
    n = codes_t.shape[1]
    ct = cb // lsub
    key = w2 - int8_matmul(qc, codes_t) * lsub               # [B, N]
    od = key.view(b, n // cb, lsub, ct).amin(dim=2).reshape(b, -1)
    if groups <= 1:
        return od
    og = od.view(b, -1, groups, ct // groups).amin(dim=2).reshape(b, -1)
    return od, og


def fused_scan_bucket_int_packed(qc, w2, codes_t, *, lsub: int = 32,
                                 cb: int = 4096, groups: int = 0):
    """Packed-key int8 scan.

    Args:
      qc:      [B, D] int8 query codes (one shared scale).
      w2:      [1, N] int32 packed weights from :func:`pack_w2`.
      codes_t: [D, N] int8 point codes (one shared scale), contiguous.
    Returns ``keys [B, N/lsub]`` int32, block-major; with ``groups > 1``
    also ``og [B, N/(lsub*groups)]``, og's column i being the min of key
    columns ``(i // ctg) * ct + g * ctg + i % ctg`` for g < groups
    (ctg = ct // groups).  Requires lsub a power of two, lsub | cb | N
    and D * lsub <= 16384 (keys stay inside int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    tensors = (qc, w2, codes_t)
    if not _on_card(tensors):
        return fused_scan_bucket_int_packed_plain(
            qc, w2, codes_t, lsub=lsub, cb=cb, groups=groups)
    _check(qc, w2, codes_t, lsub, cb, groups)
    b = qc.shape[0]
    n = codes_t.shape[1]
    dev = qc.device
    od = torch.empty((b, n // lsub), dtype=torch.int32, device=dev)
    og = (torch.empty((b, n // (lsub * groups)), dtype=torch.int32,
                      device=dev) if groups > 1 else None)
    if b and n:
        q, pm, dpad = _tile_args(qc, codes_t, lsub, cb)
        w2 = _aligned(w2)
        _launch("fused_scan_bucket_int_packed", "idt_packed_scan", dev,
                _ptr(q), _ptr(w2), _ptr(pm), _ptr(od), _ptr(og),
                b, dpad, n, lsub, cb, groups)
    return (od, og) if groups > 1 else od


# ---------------------------------------------------------------------------
# K2 / K3 / K5: group minima with their argmin
# ---------------------------------------------------------------------------

def _strided_min(val, lsub: int, cb: int):
    """[B, N] values -> (min [B, N/lsub], point id of the min [B, N/lsub])
    per stride group, block-major, as the JAX kernels reduce: slab by
    slab, a later slab winning only on a strict ``<``; ``torch.minimum``
    keeps a NaN, as ``jnp.minimum`` does."""
    b, n = val.shape
    ct = cb // lsub
    v = val.view(b, n // cb, lsub, ct)
    m = v[:, :, 0]
    am = torch.zeros(m.shape, dtype=torch.int32, device=val.device)
    for t in range(1, lsub):
        blk = v[:, :, t]
        am = torch.where(blk < m, t, am)
        m = torch.minimum(m, blk)
    first = torch.arange(0, n, cb, dtype=torch.int32,
                         device=val.device)[None, :, None]
    lane = torch.arange(ct, dtype=torch.int32, device=val.device)
    ids = first + am * ct + lane
    return m.reshape(b, -1), ids.reshape(b, -1)


def _check_bucket(qc, qs, codes_t, scales, norms, lsub: int, cb: int):
    _check_operands(qc, codes_t, qs=(qs, torch.float32, "B"),
                    scales=(scales, torch.float32, "N"),
                    norms=(norms, torch.float32, "N"))
    _check_blocks(codes_t.shape[1], lsub, cb)


def _check_int(qc, w, codes_t, lsub: int, cb: int):
    _check_operands(qc, codes_t, w=(w, torch.int32, "N"))
    _check_blocks(codes_t.shape[1], lsub, cb)


def fused_scan_bucket_plain(qc, qs, codes_t, scales, norms, *, lsub: int,
                            cb: int, is_dot: bool = False):
    """Plain torch version of :func:`fused_scan_bucket`: the whole [B, N]
    distance matrix in the kernel's order of operations, then the
    strided min."""
    _check_bucket(qc, qs, codes_t, scales, norms, lsub, cb)
    prod = (qs * scales) * int8_matmul(qc, codes_t).float()
    dist = norms - prod if is_dot else norms - 2.0 * prod
    m, ids = _strided_min(dist, lsub, cb)
    return m, torch.where(torch.isfinite(m), ids, -1)


def fused_scan_bucket(qc, qs, codes_t, scales, norms, *, lsub: int = 16,
                      cb: int = 4096, is_dot: bool = False):
    """Fused scan, bucket-min form (kernel K2).

    Args:
      qc:      [B, D] int8 query codes, per-query scales.
      qs:      [B, 1] f32 query scales (divided by |q| for cosine).
      codes_t: [D, N] int8 point codes, per-point scales.
      scales:  [1, N] f32 point scales (times 1/|p_hat| for cosine).
      norms:   [1, N] f32: |p_hat|^2, or under ``is_dot`` the 0 bias;
               +inf marks ineligible and padded points.
    Returns ``(dists [B, N/lsub] f32, ids [B, N/lsub] int32)``, block-
    major: per stride group, the min of ``norms - 2 * (qs * s) * dot``
    (or ``norms - (qs * s) * dot`` under ``is_dot``) and the point id
    that reaches it, -1 where the min is not finite.  Requires
    lsub | cb | N.  The JAX kernel's ``inner`` sub-chunking does not
    change the layout, so there is none here.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    tensors = (qc, qs, codes_t, scales, norms)
    if not _on_card(tensors):
        return fused_scan_bucket_plain(qc, qs, codes_t, scales, norms,
                                       lsub=lsub, cb=cb, is_dot=is_dot)
    _check_bucket(qc, qs, codes_t, scales, norms, lsub, cb)
    b = qc.shape[0]
    n = codes_t.shape[1]
    dev = qc.device
    od = torch.empty((b, n // lsub), dtype=torch.float32, device=dev)
    oi = torch.empty((b, n // lsub), dtype=torch.int32, device=dev)
    if b and n:
        q, pm, dpad = _tile_args(qc, codes_t, lsub, cb)
        scales, norms = _aligned(scales), _aligned(norms)
        _launch("fused_scan_bucket", "idt_bucket_scan", dev, _ptr(q),
                _ptr(qs), _ptr(pm), _ptr(scales), _ptr(norms), _ptr(od),
                _ptr(oi), b, dpad, n, lsub, cb, int(is_dot))
    return od, oi


def fused_scan_bucket_int_plain(qc, w, codes_t, *, lsub: int, cb: int):
    """Plain torch version of :func:`fused_scan_bucket_int`: the whole
    [B, N] rank matrix (int32, wrapping as XLA's), then the strided
    min."""
    _check_int(qc, w, codes_t, lsub, cb)
    m, ids = _strided_min(w - int8_matmul(qc, codes_t), lsub, cb)
    return m, torch.where(m < INT_RANK_LIMIT, ids, -1)


def fused_scan_bucket_int(qc, w, codes_t, *, lsub: int = 32,
                          cb: int = 4096):
    """Int-epilogue fused scan (kernel K3).

    Args:
      qc:      [B, D] int8 query codes, ONE shared scale qs.
      w:       [1, N] int32 ``round(|p_hat|^2 / (2 qs s))``, with
               INT32_MAX // 2 marking ineligible and padded points.
      codes_t: [D, N] int8 point codes, ONE shared scale s.
    Returns ``(rank [B, N/lsub] int32, ids [B, N/lsub] int32)`` laid out
    as :func:`fused_scan_bucket`'s: per stride group the min of
    ``w - dot`` (two's-complement int32) and the point id reaching it,
    -1 where the min is at least :data:`INT_RANK_LIMIT`.  Requires
    lsub | cb | N.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    tensors = (qc, w, codes_t)
    if not _on_card(tensors):
        return fused_scan_bucket_int_plain(qc, w, codes_t, lsub=lsub, cb=cb)
    _check_int(qc, w, codes_t, lsub, cb)
    b = qc.shape[0]
    n = codes_t.shape[1]
    dev = qc.device
    od = torch.empty((b, n // lsub), dtype=torch.int32, device=dev)
    oi = torch.empty((b, n // lsub), dtype=torch.int32, device=dev)
    if b and n:
        q, pm, dpad = _tile_args(qc, codes_t, lsub, cb)
        w = _aligned(w)
        _launch("fused_scan_bucket_int", "idt_bucket_scan_int", dev,
                _ptr(q), _ptr(w), _ptr(pm), _ptr(od), _ptr(oi), b, dpad, n,
                lsub, cb)
    return od, oi


def _check_topt(qc, qs, codes_t, scales, norms, lsub: int, cb: int,
                topt: int):
    _check_bucket(qc, qs, codes_t, scales, norms, lsub, cb)
    if topt < 1:
        raise ValueError(f"topt must be >= 1, got {topt}")


def fused_scan_topt_plain(qc, qs, codes_t, scales, norms, *, lsub: int,
                          topt: int, cb: int, is_dot: bool = False):
    """Plain torch version of :func:`fused_scan_topt`: K2's plain group
    minima, then the JAX kernel's extraction rounds."""
    _check_topt(qc, qs, codes_t, scales, norms, lsub, cb, topt)
    od, oi = fused_scan_bucket_plain(qc, qs, codes_t, scales, norms,
                                     lsub=lsub, cb=cb, is_dot=is_dot)
    b = od.shape[0]
    nc = codes_t.shape[1] // cb
    m = od.view(b, nc, -1)
    ids = oi.view(b, nc, -1)
    out_d, out_i = [], []
    for _ in range(topt):
        mv = m.amin(dim=2, keepdim=True)
        fin = torch.isfinite(mv)
        tie = torch.where((m == mv) & fin, ids, _I32MAX)
        mi = tie.amin(dim=2, keepdim=True)
        out_d.append(mv)
        out_i.append(torch.where(fin, mi, -1))
        m = torch.where(ids == mi, torch.inf, m)
    return (torch.cat(out_d, 2).reshape(b, nc * topt),
            torch.cat(out_i, 2).reshape(b, nc * topt))


def fused_scan_topt(qc, qs, codes_t, scales, norms, *, lsub: int = 16,
                    topt: int = 8, cb: int = 4096, is_dot: bool = False):
    """Fused scan with per-block top-T (kernel K5).

    Same operands as :func:`fused_scan_bucket`.  Returns
    ``(dists [B, (N/cb) * topt] f32, ids [B, (N/cb) * topt] int32)``:
    for each cb-point block and query, ``topt`` rounds over the block's
    stride-group minima, each taking the smallest distance, the smallest
    id among the groups at that distance, and removing that group; ids
    are -1 where the distance is not finite (a block with fewer eligible
    points).  Requires lsub | cb | N.  On the card, a cb block of more
    than 128 groups (cb / lsub > 128) spans several of the kernel's
    column tiles: each writes its top ``topt`` to a scratch tensor
    [B, N/cb, tiles, topt], which a second kernel of the same launch
    merges.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    tensors = (qc, qs, codes_t, scales, norms)
    if not _on_card(tensors):
        return fused_scan_topt_plain(qc, qs, codes_t, scales, norms,
                                     lsub=lsub, topt=topt, cb=cb,
                                     is_dot=is_dot)
    _check_topt(qc, qs, codes_t, scales, norms, lsub, cb, topt)
    b = qc.shape[0]
    n = codes_t.shape[1]
    dev = qc.device
    od = torch.empty((b, (n // cb) * topt), dtype=torch.float32, device=dev)
    oi = torch.empty((b, (n // cb) * topt), dtype=torch.int32, device=dev)
    if b and n:
        q, pm, dpad = _tile_args(qc, codes_t, lsub, cb)
        scales, norms = _aligned(scales), _aligned(norms)
        tiles = -(-(cb // lsub) // _TILE_N)
        sv = si = None
        if tiles > 1:
            sv = torch.empty((b, n // cb, tiles, topt), dtype=torch.float32,
                             device=dev)
            si = torch.empty(sv.shape, dtype=torch.int32, device=dev)
        _launch("fused_scan_topt", "idt_topt_scan", dev, _ptr(q), _ptr(qs),
                _ptr(pm), _ptr(scales), _ptr(norms), _ptr(od), _ptr(oi),
                _ptr(sv), _ptr(si), b, dpad, n, lsub, cb, topt,
                int(is_dot))
    return od, oi


# ---------------------------------------------------------------------------
# K6: the timing probe
# ---------------------------------------------------------------------------

#: K6's cut points, in the C entry point's numbering.
PROBES = ("full", "min", "mm")


def _check_probe(qc, w2, codes_t, lsub: int, cb: int, inner: int,
                 probe: str) -> None:
    _check(qc, w2, codes_t, lsub, cb, 0)
    if probe not in PROBES:
        raise ValueError(f"probe must be one of {PROBES}, got {probe!r}")
    if inner < 1 or codes_t.shape[1] % (cb * inner):
        raise ValueError(f"need cb * inner | N, got cb={cb} inner={inner} "
                         f"N={codes_t.shape[1]}")


def fused_scan_probe_plain(qc, w2, codes_t, *, lsub: int = 64,
                           cb: int = 8192, inner: int = 1,
                           probe: str = "full"):
    """Plain torch version of :func:`fused_scan_probe`."""
    _check_probe(qc, w2, codes_t, lsub, cb, inner, probe)
    if probe == "full":
        return fused_scan_bucket_int_packed_plain(qc, w2, codes_t,
                                                  lsub=lsub, cb=cb)
    b = qc.shape[0]
    n = codes_t.shape[1]
    dot = int8_matmul(qc, codes_t).view(b, n // cb, lsub, cb // lsub)
    out = dot[:, :, 0] if probe == "mm" else dot.amin(dim=2)
    return out.reshape(b, -1)


def fused_scan_probe(qc, w2, codes_t, *, lsub: int = 64, cb: int = 8192,
                     inner: int = 1, probe: str = "full"):
    """Timing probe of K1 (kernel K6), operands as
    :func:`fused_scan_bucket_int_packed`'s.  Returns ``od [B, N/lsub]``
    int32, laid out as K1's keys:

    * ``"full"``: K1's keys (no groups), equal to K1's bit for bit;
    * ``"min"``:  per stride group the min of the raw int32 dot;
    * ``"mm"``:   the dot of each group's slab-0 point; on the card every
      slab's product is still computed, as the TPU's matrix unit computes
      the whole block.

    ``inner`` is accepted only for parity with the JAX signature (its
    sub-block count); neither the kernel nor the output depends on it,
    and it only has to divide N / cb.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise.
    """
    tensors = (qc, w2, codes_t)
    if not _on_card(tensors):
        return fused_scan_probe_plain(qc, w2, codes_t, lsub=lsub, cb=cb,
                                      inner=inner, probe=probe)
    _check_probe(qc, w2, codes_t, lsub, cb, inner, probe)
    b = qc.shape[0]
    n = codes_t.shape[1]
    dev = qc.device
    od = torch.empty((b, n // lsub), dtype=torch.int32, device=dev)
    if b and n:
        q, pm, dpad = _tile_args(qc, codes_t, lsub, cb)
        w2 = _aligned(w2)
        _launch("fused_scan_probe", "idt_probe_scan", dev, _ptr(q),
                _ptr(w2), _ptr(pm), _ptr(od), b, dpad, n, lsub, cb,
                PROBES.index(probe))
    return od
