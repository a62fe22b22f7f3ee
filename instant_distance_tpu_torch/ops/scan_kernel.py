"""Packed-key int8 scan (port of K1, ``fused_scan_bucket_int_packed`` in
``instant_distance_tpu/ops/scan_kernel.py``), its operands and its key
format.

One int8 x int8 product of a query batch against every point, reduced in
the same pass to one int32 key per ``lsub``-wide stride group:

    key[b, o] = min_t ( w2[p] - dot(qc[b], codes_t[:, p]) * lsub ),
    p = (o // ct) * cb + t * ct + o % ct,   ct = cb // lsub.

``w2`` (:func:`pack_w2`) packs the point's rank weight with its slab
index ``t`` in the low bits, so the winning key also says which point of
the group won: id = (o // ct) * cb + (key & (lsub - 1)) * ct + o % ct
(:func:`decode_keys`).  Both callers, the wave build and
``ScanIndex(fused="bucket_pack")``, take their operands from
:func:`pack_operands` and :func:`quantize_batch`.

:func:`fused_scan_bucket_int_packed` launches the hand-written CUDA
kernel (``csrc/scan_kernel.cu``) on CUDA tensors and runs the plain
torch version, :func:`fused_scan_bucket_int_packed_plain`, on CPU
tensors.  The two agree bit for bit.
"""

from __future__ import annotations

import torch

#: Packed-key constants, as in the JAX package: real keys lie in
#: [2^23, 9*2^27), keys of groups with no eligible point at or above
#: PACK_THRESH (see instant_distance_tpu/ops/scan_kernel.py:252-268).
PACK_INELIGIBLE = 3 << 29
PACK_THRESH = 9 << 27
PACK_OFFSET = 1 << 23

#: Kernel launches so far (CUDA only; the plain version does not count).
launches = 0


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


def pack_operands(points, cb: int):
    """Point-side operands of the packed-key scan over ``points`` [N, D]
    f32: ONE global scale ``sg``, the codes transposed to [D, Npad] int8
    and the dequantized squared norms [1, Npad] with +inf padding, Npad
    the next multiple of ``cb``.  Returns (codes_t, norms_r, sg)."""
    sg = torch.clamp(points.abs().max(), min=1e-30) / 127.0
    codes = torch.clamp(torch.round(points / sg), -127, 127).to(torch.int8)
    deq = codes.float() * sg
    norms = (deq * deq).sum(1)
    npad = (-points.shape[0]) % cb
    codes_t = torch.nn.functional.pad(codes, (0, 0, 0, npad)).T.contiguous()
    norms_r = torch.nn.functional.pad(norms, (0, npad),
                                      value=torch.inf)[None, :]
    return codes_t, norms_r, sg


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


def _check(qc, w2, codes_t, lsub: int, cb: int, groups: int) -> None:
    if (qc.dtype != torch.int8 or codes_t.dtype != torch.int8
            or w2.dtype != torch.int32):
        raise TypeError(f"want int8/int32/int8 operands, got {qc.dtype}/"
                        f"{w2.dtype}/{codes_t.dtype}")
    if qc.dim() != 2 or codes_t.dim() != 2:
        raise ValueError("qc must be [B, D] and codes_t [D, N]")
    b, d = qc.shape
    n = codes_t.shape[1]
    if codes_t.shape[0] != d or tuple(w2.shape) != (1, n):
        raise ValueError(f"shape mismatch: qc {tuple(qc.shape)}, w2 "
                         f"{tuple(w2.shape)}, codes_t {tuple(codes_t.shape)}")
    if lsub < 1 or lsub & (lsub - 1):
        raise ValueError(f"lsub must be a power of two, got {lsub}")
    if d * lsub > 16384:
        raise ValueError(f"D*lsub = {d * lsub} > 16384: packed keys could "
                         "overflow")
    if cb % lsub or n % cb:
        raise ValueError(f"need lsub | cb | N, got lsub={lsub} cb={cb} N={n}")
    ct = cb // lsub
    if groups > 1 and (groups & (groups - 1) or ct % groups):
        raise ValueError(f"groups must be a power of two dividing "
                         f"cb/lsub = {ct}, got {groups}")


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
    global launches
    tensors = (qc, w2, codes_t)
    if all(t.device.type == "cpu" for t in tensors):
        return fused_scan_bucket_int_packed_plain(
            qc, w2, codes_t, lsub=lsub, cb=cb, groups=groups)
    dev = qc.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("qc, w2 and codes_t must share one CUDA device "
                         f"(or all be on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    _check(qc, w2, codes_t, lsub, cb, groups)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the packed-scan kernel needs contiguous operands")
    b, d = qc.shape
    n = codes_t.shape[1]
    if b > 65535 * 64:
        raise ValueError(f"batch {b} exceeds the kernel grid")
    od = torch.empty((b, n // lsub), dtype=torch.int32, device=dev)
    og = (torch.empty((b, n // (lsub * groups)), dtype=torch.int32,
                      device=dev) if groups > 1 else None)
    if b and n:
        from ._build import check, library

        lib = library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.idt_packed_scan(
                qc.data_ptr(), w2.data_ptr(), codes_t.data_ptr(),
                od.data_ptr(), og.data_ptr() if og is not None else None,
                b, d, n, lsub, cb, groups, stream)
        check(lib, rc, "packed_scan_kernel")
        launches += 1
    return (od, og) if groups > 1 else od
