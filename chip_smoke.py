#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's main path through the entry points a user calls, at
the repo's real configuration (SIFT1M-shaped clustered data, 1M x 128,
sqeuclidean, m=32):

  1. device   — needs CUDA; prints the card's name and power limit;
  2. build    — compiles the CUDA kernel from csrc/ (nvcc, at first use);
  3. kernel   — the packed-key scan kernel vs its plain torch version:
                on a slice the plain version holds whole, then on the
                main path's own calls (the build's last wave, the scan
                batch); bit-exact keys, both times from CUDA events;
  4. scan     — ScanIndex(fused="bucket_pack") over 1M points, an
                8192-query batch: qps and recall@10 against BruteForce;
  5. hnsw     — Hnsw.build at --build-n points (default 1M), then
                search_batch(ef=50): build time, qps and recall@10;
  6. launches — the kernel must have run inside phases 4 and 5.

Every phase prints one line; any failure raises and the exit code is
not 0.  The last two lines are the kernel record and the device record,
one JSON object each.  Run from the repository root:

    python3 chip_smoke.py [--build-n N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_POINTS, DIM, N_QUERIES = 1_000_000, 128, 8192
BLOCK, N_BLOCKS, K = 1024, 3, 10
RECALL_FLOOR = 0.95   # minimum recall@10 over the disjoint query blocks
SCAN_KW = dict(k=K, fused="bucket_pack", lsub=64, cb=8192, inner=2, ef=32)
KERNEL_SRC = "instant_distance_tpu_torch/csrc/scan_kernel.cu"
KERNEL_REPLACES = "instant_distance_tpu/ops/scan_kernel.py:304"


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def _cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _wall_s(torch, fn, iters: int = 5) -> float:
    """Mean host seconds per call, each ended by a device sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def _recall_blocks(found, truth):
    """recall@K of each disjoint BLOCK-query block."""
    from instant_distance_tpu_torch.utils.metrics import recall_at_k

    found, truth = np.asarray(found), np.asarray(truth)
    return [recall_at_k(found[b * BLOCK:(b + 1) * BLOCK],
                        truth[b * BLOCK:(b + 1) * BLOCK], K)
            for b in range(N_BLOCKS)]


def _check_results(torch, d, i, n_rows: int, what: str) -> None:
    if tuple(i.shape) != (n_rows, K) or tuple(d.shape) != (n_rows, K):
        raise AssertionError(f"{what}: result shape {tuple(i.shape)}")
    if not bool(torch.isfinite(d).all()) or not bool((i >= 0).all()):
        raise AssertionError(f"{what}: non-finite distance or missing id")


def _padded(n: int, to: int) -> int:
    return -(-n // to) * to


#: Phase 3's cases, (label, B, N, groups) at D=128, lsub=64, cb=8192: the
#: slice that the plain version holds whole, then the two calls of the
#: main path at full size: the 1M build's last wave (4096 queries against
#: every point, padded to cb) and the ScanIndex batch (points padded to
#: cb * inner).
KERNEL_CASES = (
    ("slice", 1024, 65536, (0, 2)),
    ("build wave", 4096, _padded(N_POINTS, SCAN_KW["cb"]), (0,)),
    ("scan batch", N_QUERIES,
     _padded(N_POINTS, SCAN_KW["cb"] * SCAN_KW["inner"]), (0,)),
)


def _plain_by_rows(torch, tsk, qc, w2, codes, groups: int):
    """The plain version over blocks of query rows, concatenated: rows
    are independent, and a block's [rows, N] key matrix fits the card
    where the whole batch's would not."""
    rows = max(1, (1 << 28) // codes.shape[1])
    outs = [tsk.fused_scan_bucket_int_packed_plain(
        qc[s:s + rows], w2, codes, lsub=SCAN_KW["lsub"], cb=SCAN_KW["cb"],
        groups=groups) for s in range(0, qc.shape[0], rows)]
    if groups > 1:
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def _kernel_case(torch, tsk, dev, b: int, n: int, groups_list):
    """One case of phase 3: (max |key difference|, kernel ms, plain ms)."""
    d, lsub, cb = DIM, SCAN_KW["lsub"], SCAN_KW["cb"]
    g = torch.Generator(device=dev).manual_seed(b + n)
    qc = torch.randint(-127, 128, (b, d), generator=g, device=dev,
                       dtype=torch.int8)
    codes = torch.randint(-127, 128, (d, n), generator=g, device=dev,
                          dtype=torch.int8)
    norms = torch.rand((1, n), generator=g, device=dev) * 4
    norms[0, N_POINTS if n > N_POINTS else n - 5000:] = torch.inf  # padding
    eligible = torch.rand((1, n), generator=g, device=dev) < 0.9
    w2 = tsk.pack_w2(norms, torch.tensor(2 * 0.011 * 0.019, device=dev),
                     eligible, lsub=lsub, cb=cb, d=d)
    max_err = 0
    for groups in groups_list:
        got = tsk.fused_scan_bucket_int_packed(qc, w2, codes, lsub=lsub,
                                               cb=cb, groups=groups)
        want = _plain_by_rows(torch, tsk, qc, w2, codes, groups)
        got = got if groups > 1 else (got,)
        want = want if groups > 1 else (want,)
        for x, y in zip(got, want):
            max_err = max(max_err, int((x.long() - y.long()).abs().max()))
    del got, want

    def kern():
        tsk.fused_scan_bucket_int_packed(qc, w2, codes, lsub=lsub, cb=cb)

    def plain():
        _plain_by_rows(torch, tsk, qc, w2, codes, 0)

    # in turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = (_cuda_ms(torch, f) for f in (plain, kern, kern, plain))
    return max_err, (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernel(torch, tsk, dev):
    """Phase 3: the kernel against its plain version, keys bit-exact,
    both timed.  Returns (max |difference|, kernel ms, plain ms) of the
    last case, the ScanIndex batch."""
    max_err, parts = 0, []
    for label, b, n, groups_list in KERNEL_CASES:
        err, ms, plain_ms = _kernel_case(torch, tsk, dev, b, n, groups_list)
        max_err = max(max_err, err)
        parts.append(f"{label} B={b} N={n} groups {groups_list}: kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    if max_err != 0:
        raise AssertionError(f"kernel keys differ from plain: {max_err}")
    _phase("kernel", f"D={DIM} lsub={SCAN_KW['lsub']} cb={SCAN_KW['cb']}, "
           f"keys bit-exact in every case; " + "; ".join(parts))
    return max_err, ms, plain_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-n", type=int, default=N_POINTS,
                    help="points in the HNSW build (default: 1M)")
    args = ap.parse_args(argv)

    import torch

    # -- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _phase("device", f"{name}, {count} visible, torch {torch.__version__} "
           f"cuda {torch.version.cuda}")
    print(smi, flush=True)

    import instant_distance_tpu_torch as idt
    from instant_distance_tpu_torch.ops import _build
    from instant_distance_tpu_torch.ops import scan_kernel as tsk
    from instant_distance_tpu_torch.utils.datasets import synthetic_clustered

    # -- 2. kernel build -------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    _phase("build", f"{time.perf_counter() - t0:.2f} s "
           f"(nvcc {_build.build_seconds:.2f} s); {' | '.join(ptxas)}")

    # -- 3. kernel vs plain ----------------------------------------------
    max_err, ms, plain_ms = phase_kernel(torch, tsk, dev)

    # -- 4. ScanIndex, bucket_pack, 1M x 128 -------------------------------
    t0 = time.perf_counter()
    data = synthetic_clustered(N_POINTS + N_QUERIES, DIM, n_clusters=10000,
                               seed=3)
    pts = torch.from_numpy(data[:N_POINTS]).to(dev)
    queries = torch.from_numpy(data[N_POINTS:]).to(dev)
    del data
    data_s = time.perf_counter() - t0
    nq = N_BLOCKS * BLOCK
    gt = idt.BruteForce(pts).search_batch(queries[:nq], K)[1].cpu()

    tsk.launches = 0   # count only the main path from here on
    scan = idt.ScanIndex(pts)
    d, i = scan.search_batch(queries, **SCAN_KW)
    _check_results(torch, d, i, N_QUERIES, "scan")
    recs = _recall_blocks(i[:nq].cpu(), gt)
    t = _wall_s(torch, lambda: scan.search_batch(queries, **SCAN_KW))
    scan_launches = tsk.launches
    _phase("scan", f"ScanIndex bucket_pack {N_POINTS}x{DIM}, batch "
           f"{N_QUERIES}: {N_QUERIES / t:.1f} qps ({t * 1e3:.2f} ms/batch), "
           f"recall@10 blocks {[round(r, 4) for r in recs]} "
           f"(data {data_s:.1f} s)")
    if min(recs) < RECALL_FLOOR:
        raise AssertionError(f"scan recall {min(recs)} < {RECALL_FLOOR}")
    del scan

    # -- 5. HNSW build + search ------------------------------------------
    bn = min(args.build_n, N_POINTS)
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50)
    marks = {}

    def progress(done, total, phase):
        step = done * 10 // total
        if step not in marks:
            marks[step] = time.perf_counter()
            print(f"  build {done}/{total} ({phase}) at "
                  f"{marks[step] - t0:.1f} s", file=sys.stderr, flush=True)

    before = tsk.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, _ = idt.Hnsw.build(pts[:bn], cfg, progress=progress)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = tsk.launches - before
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    gt = idt.BruteForce(index.points).search_batch(queries[:nq], K)[1].cpu()
    d, p = index.search_batch(queries[:nq], k=K, ef=50)
    _check_results(torch, d, p, nq, "hnsw")
    recs = _recall_blocks(p.cpu(), gt)
    t = _wall_s(torch, lambda: index.search_batch(queries[:BLOCK], k=K,
                                                  ef=50))
    _phase("hnsw", f"build {bn}x{DIM} m=32 wave 4096: {build_s:.1f} s "
           f"({bn / build_s:.1f} pts/s), peak memory {peak_gib:.2f} GiB, "
           f"reverse drops {index.reverse_drops}; search ef=50 batch {BLOCK}: "
           f"{BLOCK / t:.1f} qps, recall@10 blocks "
           f"{[round(r, 4) for r in recs]}")
    if min(recs) < RECALL_FLOOR:
        raise AssertionError(f"hnsw recall {min(recs)} < {RECALL_FLOOR}")

    # -- 6. the main path ran through the kernel --------------------------
    _phase("launches", f"packed-scan kernel: {scan_launches} in the scan "
           f"phase (one per batch, timed repeats included), "
           f"{build_launches} in the build phase")
    if scan_launches < 1 or build_launches < 1:
        raise AssertionError("the main path did not launch the kernel")

    print(json.dumps({"kernels": [{
        "name": "fused_scan_bucket_int_packed", "route": "cuda",
        "source": KERNEL_SRC, "replaces": KERNEL_REPLACES,
        "launches": scan_launches + build_launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
