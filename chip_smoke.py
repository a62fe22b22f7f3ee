#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Drives the port's paths through the entry points a user calls, at the
repo's real configurations, and holds every CUDA kernel of those paths
against its plain torch version:

  1. device   — needs CUDA; prints the card's name and power limit;
  2. build    — compiles csrc/*.cu (one nvcc per source, in parallel),
                prints each kernel's registers and spills (ptxas) and its
                tensor-core, TMA and __dp4a instruction counts (cuobjdump
                -sass), and fails unless K1/K6 and K2/K3 run on the Hopper
                tile (warpgroup MMA, IGMMA, fed by TMA loads, UTMALDG, and
                no mma.sync IMMA) and K5 on the mma.sync tile (IMMA), none
                with a __dp4a; prints the Hopper tile's shared memory a
                block and stages at the paths' widths, and K4's shared
                memory a block and blocks an SM at the packed calls'
                shapes;
  3. kernels  — each kernel (K1 packed keys, K2 bucket, K3 bucket_int,
                K5 topt, K4 walk, K6 probe in its three modes) vs its
                plain version on random inputs from a seeded generator on
                the card: a slice, then the paths' own call shapes (K4 on
                a random valid graph of 65,536 nodes, K = 64, D 128 and
                300, expand 1 and 2); results bit-exact,
                both timed with CUDA events in turns, each scan with its
                TOP/s and its share of the bound; torch._int_mm on K1's
                product as the yardstick of K6's "mm" mode; K6 also at
                K2's 300-d build wave shape, which splits K2's time into
                the tile's product and K2's f32 epilogue; K2 also on K5's
                topt-batch operands, which splits K5's time into K2's
                group minima and the top-T merge;
  4. scan     — ScanIndex(fused="bucket_pack") over SIFT1M-shaped data
                (1M x 128), an 8192-query batch: qps, recall@10 vs
                BruteForce (K1); the grouped selections on the same index
                (scan kgroup: bench.py's sel_kgroup=2 arguments, K1 with
                groups; scan group: sel_group=4); then the attribution
                path: K6's three modes on that very batch's operands,
                timed beside K1;
  5. hnsw     — Hnsw.build at --build-n points (default 1M) of that data,
                then search_batch(ef=50): build time, qps, recall (K1);
     hybrid   — HybridIndex over that graph with a ScanIndex of its points
                as the device route: the lift to the host engine, host qps
                on all cores, single-query p50 on the host, the device and
                the hybrid after calibrate(), and the routing gates (B=1
                equal to the host engine's result, a filter on the device,
                threshold 1 equal to the ScanIndex's result);
  6. packed   — the serving flow on that index: dump (native npz), load,
                PackedHnsw.from_index, search_batch_kernel (K4) on an
                8192-query batch with the seed scan, once more with
                merge="extract" (the same kernel), K4 against its plain
                version at that very call, and the plain-op search_batch
                at the same settings;
  7. scan300  — fastText-shaped data (1M x 300, the width of the
                reference binding's FloatArray): ScanIndex with the same
                bucket_pack request, which runs K3 at 300-d, then cosine
                ScanIndex fused="bucket" (K2) and fused="topt" (K5);
  8. hnsw300  — HnswMap.build of those 1M x 300 points with string
                values, sqeuclidean (K2 in every wave), search_batch(ef=50)
                and one search through the Search iterator;
  9. packed300 — PackedHnsw.from_index of that map (D = 300 unpadded),
                search_batch_kernel (K4) and search_batch_values;
 10. add      — on phase 4's data: Hnsw.build of the first 868,928
                points (dumped), then index.add of the other 131,072 in
                four calls (K1), search_batch(ef=50) against the truth over
                all 1M, PackedHnsw.from_index of the grown index (K4), and
                a ScanIndex grown by add whose bucket_pack results must
                equal phase 4's one-shot ScanIndex bit for bit (K1);
     streaming — StreamingHnsw.load of that dump (serving="scan"), the
                same four chunks added with a compaction every 65,536
                pending rows; after each add a bucket_pack batch (K1)
                against the truth over the rows visible then, and each
                chunk's first 1,024 rows found at rank 0; then a packed
                serving form of the same graph, compiled before the last
                chunk, searched with that chunk pending;
 11. beam     — the first 65,536 rows of that data built with a torch
                callable metric (beam-mode waves, no scan kernel), and
                32,768 rows with Heuristic(extend_candidates=True) (K1);
 12. checkpoint — the first 262,144 rows with an exact prefix of
                131,072 (streamed-scan waves, then K1): build A twice
                (the build is deterministic), build B with a checkpoint
                every 8 waves stopped halfway by its progress callback,
                build C resumed from B's file: C equals A bit for bit and
                the file is gone;
     native   — Hnsw.build(backend="native") of 32,768 of those points on
                all host cores, beside the card's wave build of the same
                points; served on the card (search_batch, and PackedHnsw's
                search_batch_kernel, K4);
     cli      — python -m instant_distance_tpu_torch in subprocesses: info,
                validate, convert (npz -> bincode -> info) and selftest on
                the native index's dump, build and search on a small .npy
                (those that need no other's output at once, in two rounds);
 13. sampled  — DEEP-shaped data (1M x 96), construct_sample_cols=262,144
                with the split flag on (the repair in the commit), K1 on
                the capped columns;
     sharded  — after hnsw: ShardedHnsw.build of the 1M x 128 points on
                four shards of the card (K1 every wave of every shard),
                search_batch(ef=50) on the 8192-query batch, a filter and a
                delete, dump and ShardedHnsw.load (equal bit for bit),
                pack() and ShardedPackedHnsw.search_batch;
     replicated — after packed: ReplicatedHnsw over the loaded index on
                four slices equal to its search_batch bit for bit at B
                8192 and 8190, ReplicatedPackedHnsw equal to
                PackedHnsw.search_batch, ReplicatedScanIndex(fused=True)
                (K2), and a ReplicatedHnsw on default_mesh();
     sharded scan — ShardedScanIndex of the 1M x 128 points on four
                shards: fused=True (K2) on the whole batch, the streamed
                scan at 1024, dump and load (equal bit for bit);
     sharded checkpoint — after checkpoint: 4 x 65,536 - 3 points (the
                last shard padded): A, B stopped halfway, C resumed equal
                to A bit for bit, the recall gate over all queries and over
                the true neighbours in the last shard (K1); no list links
                to or from a pad row, and the pad rows are the last pids;
                then D, the same points under dot (K2 with is_dot): no
                pad links, and the last shard's recall over its true
                neighbours within 0.02 of the other shards' mean;
     distributed — a one-rank NCCL group through distributed_mesh: a
                ShardedHnsw of 65,536 points there equal to the same build
                on default_mesh(devices=[card]) bit for bit;
     oracle   — after phase 3: utils/refimpl.RefHnsw of 700 x 8 points
                (tests/test_beam_vs_oracle.py's data and default config)
                built on the host; ops/beam.hnsw_search on the card over
                its graph returns RefHnsw.search's pid lists exactly; the
                card's wave build of the same points reaches the oracle
                graph's recall@10 less 0.02;
     examples — the four examples of instant_distance_tpu_torch/examples
                as python -m subprocesses on the card, all at once beside
                the oracle: the lines tests/test_examples.py checks of the
                JAX examples, then translate again from its dump;
     ladder   — last: BASELINE.md's GIST1M rung, load_config("gist1m")
                (1M x 960 and its queries): ScanIndex bucket_pack at lsub
                16 (K1 at D = 960) and 32 (K3), K1 and K3 held on the
                scan's operands and K2 at a build wave's shape, Hnsw.build
                (K2), search_batch, the packed form's memory arithmetic,
                then PackedHnsw.from_index and search_batch_kernel (K4, at
                500,000 points when the packed form of 1M would not fit)
                and K4 held at that call; recall@10 of each route over one
                block of 8192 queries;
 14. launches — every kernel ran inside its paths (each path is driven
                with the launch counts set to 0 just before it and read
                just after).

Every build phase prints its wall time, build time, pts/s and peak
memory and gates recall@10 like the others.  The serving phases print the
card's name and power limit beside card numbers, and the CPU model and
core count beside host numbers.

Every phase prints a line; any failure raises and the exit code is not
0.  The last two lines are the kernel record and the device record, one
JSON object each.  Run from the repository root:

    python3 chip_smoke.py [--build-n N]

``--build-n`` shrinks only the 128-d build of phase 5.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_POINTS, DIM, DIM300, N_QUERIES = 1_000_000, 128, 300, 8192
BLOCK, N_BLOCKS, K = 1024, 3, 10
RECALL_FLOOR = 0.95   # minimum recall@10 over the disjoint query blocks
SCAN_KW = dict(k=K, fused="bucket_pack", lsub=64, cb=8192, inner=2, ef=32)
#: ScanIndex's default point block, and the build's K2 block and width.
SCAN_CB, BUILD_CB, BUILD_LSUB = 4096, 4096, 32
TOPT, TOPT_LSUB = 8, 16
#: H100 SXM peaks (NVIDIA's data sheet): dense int8 tensor-core rate,
#: f32 rate outside the tensor cores and HBM3 bandwidth.  A kernel's
#: bound is the larger of its operations and its bytes (each input read
#: once, each output written once) over them.
PEAK_INT8_OPS, PEAK_F32_OPS, PEAK_BYTES = 1979e12, 67e12, 3.35e12
#: The packed serving settings: ef, the seed scan's S, expand.
PACKED_KW = dict(k=K, ef=50, entry_seeds=8192, expand=2)
#: K4's random-graph cases: nodes, neighbours per row, batch, ef, seeds.
WALK_N, WALK_K, WALK_B, WALK_EF, WALK_S = 65536, 64, 1024, 50, 4096
#: The add path: points built first, then added in ADD_CALLS equal calls.
ADD_BASE, ADD_CALLS = N_POINTS - 131_072, 4
#: The beam path's callable build and extend_candidates build (rows of
#: phase 4's data, cut from 1M for the smoke's time).
BEAM_N, EXTEND_N = 65_536, 32_768
#: The checkpoint path: rows, exact prefix, waves between saves.
CKPT_N, CKPT_PREFIX, CKPT_EVERY = 262_144, 131_072, 8
#: The sampled path (DEEP-shaped, docs/performance.md:665-790 cut from 10M
#: points to 1M and from a 2^22 cap to 2^18, for the smoke's time).
DEEP_N, DEEP_DIM, SAMPLE_COLS = 1_000_000, 96, 262_144

#: The grouped selections of ScanIndex bucket_pack: bench.py's
#: scan_fused_kgroup arguments (bench.py:330-331; its qb is a TPU knob),
#: and sel_group at the smoke's own bucket_pack arguments.
KGROUP_KW = dict(k=K, fused="bucket_pack", cb=16384, lsub=64, inner=1,
                 sel_kgroup=2, ef=32)
GROUP_KW = dict(SCAN_KW, sel_group=4)
#: The hybrid path: queries timed one at a time, and the host batch.
P50_QUERIES, HOST_BATCH = 32, 8192
#: The native path: points built by the host engine (and by the card's
#: waves beside it), cut from 65,536 for the smoke's time.
NATIVE_N = 32_768
#: The streaming path: slab rows that trigger a compaction, and the rows
#: of each added chunk searched for themselves (read-your-writes).
STREAM_REPACK, RYW_ROWS = 65_536, 1024
#: The parallel paths: shards (or batch slices) on the one card, the
#: checkpointed sharded build's points (its last shard holds 3 pad rows)
#: and the one-rank NCCL mesh's build.
SHARDS, SHARD_CKPT_N, DIST_N = 4, 4 * 65_536 - 3, 65_536
#: The oracle path (tests/test_beam_vs_oracle.py:60-76): points, width,
#: seed, ef and queries, at the default Config; recall over more queries
#: for the wave build's gate, which may trail the oracle graph's by the
#: slack (one is sequential, the other built in waves).
ORACLE_N, ORACLE_DIM, ORACLE_SEED, ORACLE_EF, ORACLE_Q = 700, 8, 1234, 64, 8
ORACLE_RECALL_Q, ORACLE_SLACK = 1024, 0.02
#: The examples: module, arguments, lines the output must hold (those
#: tests/test_examples.py checks of the JAX examples).
EXAMPLES = (
    ("colors", [], ["red"]),
    ("translate", ["word7_en"], ["fr: word7_fr", "it: word7_it"]),
    ("filtered_serving", [], ["category-0 only:", "after delete:"]),
    ("streaming_ingest", [], ["compacted: n=5600 pending=0", "doc-7"]),
)
#: The ladder path: ScanIndex bucket_pack at cb 8192, so that lsub 16
#: stays 16 (D * lsub = 15,360: K1) and lsub 32 turns it into bucket_int
#: (K3); the query rows a block of K4's plain version; the device memory
#: kept free for the packed searches; the packed route's points where
#: the packed form of 1M points would not fit.
LADDER_SCAN_KW = dict(k=K, fused="bucket_pack", cb=8192, inner=2, ef=32)
LADDER_ROWS, LADDER_HEADROOM = 1024, 4_000_000_000
LADDER_PACKED_FALLBACK = 500_000

#: Kernels on the Hopper tile (csrc/wgmma_tile.cuh: K1 with K6; K2 and K3,
#: one template): the build phase fails unless their machine code holds
#: the warpgroup MMA (IGMMA) and TMA loads (UTMALDG), and no mma.sync
#: (IMMA) or __dp4a (IDP.4A).  Mangled, a template kernel's name is its
#: length, the name and "I" (its template arguments follow).
WGMMA_KERNELS = ("18packed_scan_kernelI", "13bucket_kernelI")
#: Kernels on the mma.sync tile (csrc/mma_tile.cuh: K5): IMMA and no
#: __dp4a.
IMMA_KERNELS = ("11topt_kernelI",)
#: The widths whose Hopper-tile plan the build phase prints: the paths'
#: 128, 300 and 960, and 1536, where the query tile streams.
PLAN_WIDTHS = (DIM, DIM300, 960, 1536)
#: K3's and K5's times at their record cases on the __dp4a tile that the
#: tensor-core tile replaced (this script on an NVIDIA H100 80GB HBM3 at
#: 700 W), printed beside the new times.
DP4A_MS = {("fused_scan_bucket_int", "scan batch"): 283.73,
           ("fused_scan_topt", "topt batch"): 456.10}

SRC = "instant_distance_tpu_torch/csrc/"
JAX_KERNELS = "instant_distance_tpu/ops/scan_kernel.py"
#: kernel -> (source, the TPU kernel's pallas_call it replaces)
KERNELS = {
    "fused_scan_bucket_int_packed": (SRC + "scan_kernel.cu",
                                     JAX_KERNELS + ":465"),
    "fused_scan_bucket": (SRC + "bucket_kernel.cu", JAX_KERNELS + ":117"),
    "fused_scan_bucket_int": (SRC + "bucket_kernel.cu", JAX_KERNELS + ":224"),
    "walk_search": (SRC + "walk_kernel.cu",
                    "instant_distance_tpu/ops/walk_kernel.py:358"),
    "fused_scan_topt": (SRC + "bucket_kernel.cu", JAX_KERNELS + ":642"),
    "fused_scan_probe": (SRC + "scan_kernel.cu", JAX_KERNELS + ":538"),
}


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


#: The card's name and power limit (nvidia-smi), and the host's CPU model
#: and core count, printed beside the numbers of the serving phases.
CARD = HOST = ""


def _cpu_model() -> str:
    """/proc/cpuinfo's model name; where that says "unknown" (as in some
    virtual machines), its vendor, family and model numbers."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    name = info.get("model name", "unknown")
    if name.lower() != "unknown":
        return name
    return (f"CPU {info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')} "
            "(model name unknown)")


def _padded(n: int, to: int) -> int:
    return -(-n // to) * to


def _cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
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


# ---------------------------------------------------------------------------
# phase 2: what the build made
# ---------------------------------------------------------------------------

def _ptxas_summary(log: str) -> list:
    """One "kernel: registers, spills" entry per entry function of nvcc's
    ``-Xptxas -v`` report."""
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append(f"{fn}: {m.group(1)} registers, {spill}")
            fn, spill = None, ""
    return out


def _sass_check(build) -> list:
    """Tensor-core (IMMA, HMMA, IGMMA, HGMMA), TMA load (UTMALDG) and
    __dp4a (IDP.4A) instruction counts of every kernel in the built
    libraries, from ``cuobjdump -sass``.  Raises unless each kernel of
    WGMMA_KERNELS holds IGMMA and UTMALDG and no IMMA, and each of
    IMMA_KERNELS IMMA, none of them a __dp4a."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    counts = {}
    for src in build._sources():
        sass = subprocess.run([tool, "-sass", build.library_path(src)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = collections.Counter()
                continue
            m = re.search(r"\b(IMMA|HMMA|IGMMA|HGMMA|UTMALDG|IDP\.?4A)"
                          r"[.\w]*", line)
            if m and fn:
                counts[fn][m.group(0)] += 1
    lines = []
    for fn, c in counts.items():
        def has(op):
            return sum(v for k, v in c.items()
                       if k.split(".")[0].startswith(op))

        if any(k in fn for k in WGMMA_KERNELS) and (
                not has("IGMMA") or not has("UTMALDG") or has("IMMA")
                or has("IDP")):
            raise AssertionError(f"{fn}: {dict(c)} (want IGMMA and UTMALDG, "
                                 "no IMMA and no IDP.4A)")
        if any(k in fn for k in IMMA_KERNELS) and (not has("IMMA")
                                                   or has("IDP")):
            raise AssertionError(f"{fn}: {dict(c)} (want IMMA and no "
                                 "IDP.4A)")
        if c:
            lines.append(f"{fn}: {dict(c)}")
    return lines


def _tile_plans(build) -> str:
    """The Hopper tile's plan (csrc/wgmma_tile.cuh) at PLAN_WIDTHS:
    threads and shared memory a block, stages of the ring, the query tile
    resident or streamed."""
    import ctypes

    from instant_distance_tpu_torch.ops.scan_kernel import padded_width

    lib = build.library()
    out = []
    for d in PLAN_WIDTHS:
        plan = (ctypes.c_int * 5)()
        lib.idt_wg_plan(padded_width(d), plan)
        out.append(f"D={d}: {plan[4]} threads and {plan[0]} B a block, "
                   f"{plan[3]} d chunks, {plan[1]} stages, query tile "
                   + ("resident" if plan[2] else "streamed"))
    return "; ".join(out)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

#: (label, kernel, B, D, N, lsub, cb, options).  The shapes of the paths'
#: own calls: K1 in the 1M x 128 build's last wave and the ScanIndex
#: batch (points padded to cb * inner); K2 in the 1M x 300 build's last
#: wave (B=4096 against every point, padded to the build's cb) and the
#: cosine "bucket" batch; K3 in the 300-d "bucket_pack" batch; K5 in the
#: cosine "topt" batch; K1 in a wave of one shard of the sharded build,
#: K2 in one shard's batch of the sharded scan and in one slice of the
#: replicated scan.  The first case of each kernel is the one its JSON
#: record reports.
KERNEL_CASES = (
    ("scan batch", "fused_scan_bucket_int_packed", N_QUERIES, DIM,
     _padded(N_POINTS, 8192 * 2), 64, 8192, {}),
    ("slice", "fused_scan_bucket_int_packed", 1024, DIM, 65536, 64, 8192,
     {"groups": 2}),
    # the sel_kgroup scan: K1 with its second-level group min
    ("kgroup batch", "fused_scan_bucket_int_packed", N_QUERIES, DIM,
     _padded(N_POINTS, KGROUP_KW["cb"]), KGROUP_KW["lsub"], KGROUP_KW["cb"],
     {"groups": KGROUP_KW["sel_kgroup"]}),
    ("build wave", "fused_scan_bucket_int_packed", 4096, DIM,
     _padded(N_POINTS, 8192), 64, 8192, {}),
    ("sharded build wave", "fused_scan_bucket_int_packed", 4096, DIM,
     _padded(N_POINTS // SHARDS, 8192), 64, 8192, {}),
    ("build wave", "fused_scan_bucket", 4096, DIM300,
     _padded(N_POINTS, BUILD_CB), BUILD_LSUB, BUILD_CB, {"is_dot": False}),
    ("slice", "fused_scan_bucket", 1000, DIM300, 65536, 32, 4096,
     {"is_dot": True}),
    ("bucket batch", "fused_scan_bucket", N_QUERIES, DIM300,
     _padded(N_POINTS, SCAN_CB), 32, SCAN_CB, {"is_dot": True}),
    # the dot build of the sharded checkpoint phase: one shard's wave
    ("sharded dot build wave", "fused_scan_bucket", 4096, DIM,
     _padded(-(-SHARD_CKPT_N // SHARDS), BUILD_CB), BUILD_LSUB, BUILD_CB,
     {"is_dot": True}),
    ("sharded scan batch", "fused_scan_bucket", N_QUERIES, DIM,
     _padded(N_POINTS // SHARDS, SCAN_CB), 32, SCAN_CB, {"is_dot": False}),
    ("replicated scan slice", "fused_scan_bucket", N_QUERIES // SHARDS, DIM,
     _padded(N_POINTS, SCAN_CB), 32, SCAN_CB, {"is_dot": False}),
    ("scan batch", "fused_scan_bucket_int", N_QUERIES, DIM300,
     _padded(N_POINTS, 8192 * 2), 64, 8192, {}),
    ("slice", "fused_scan_bucket_int", 1000, DIM300, 65536, 64, 8192, {}),
    ("topt batch", "fused_scan_topt", N_QUERIES, DIM300,
     _padded(N_POINTS, SCAN_CB), TOPT_LSUB, SCAN_CB, {"is_dot": True}),
    # K2 on K5's very operands (same shape and seed): K5's group minima
    # without the top-T merge
    ("topt batch", "fused_scan_bucket", N_QUERIES, DIM300,
     _padded(N_POINTS, SCAN_CB), TOPT_LSUB, SCAN_CB, {"is_dot": True}),
    ("slice", "fused_scan_topt", 1000, DIM300, 65536, TOPT_LSUB, 4096,
     {"is_dot": False}),
    # K6 at K1's ScanIndex batch shape; "mm" first, the record's case
    ("scan batch mm", "fused_scan_probe", N_QUERIES, DIM,
     _padded(N_POINTS, 8192 * 2), 64, 8192, {"probe": "mm", "inner": 2}),
    ("scan batch min", "fused_scan_probe", N_QUERIES, DIM,
     _padded(N_POINTS, 8192 * 2), 64, 8192, {"probe": "min", "inner": 2}),
    ("scan batch full", "fused_scan_probe", N_QUERIES, DIM,
     _padded(N_POINTS, 8192 * 2), 64, 8192, {"probe": "full", "inner": 2}),
    # K6 at K2's 300-d build wave shape: the same tile's product and min
    # chain without K2's f32 epilogue, so K2's time splits too
    ("K2 build wave mm", "fused_scan_probe", 4096, DIM300,
     _padded(N_POINTS, BUILD_CB), BUILD_LSUB, BUILD_CB, {"probe": "mm"}),
    ("K2 build wave min", "fused_scan_probe", 4096, DIM300,
     _padded(N_POINTS, BUILD_CB), BUILD_LSUB, BUILD_CB, {"probe": "min"}),
)
#: The ladder's kernel shapes at D = 960 (GIST1M): K1 and K3 in its
#: ScanIndex batches at lsub 16 and 32 (cb 8192, points padded to cb *
#: inner), K2 in its build's waves.  The ladder phase holds K1 and K3 on
#: its scan's own operands and K2 on random ones of this shape;
#: tools/time_torch_kernels.py times all three on random operands.
LADDER_CASES = (
    ("ladder scan lsub 16", "fused_scan_bucket_int_packed", N_QUERIES, 960,
     _padded(N_POINTS, 8192 * 2), 16, 8192, {}),
    ("ladder scan lsub 32", "fused_scan_bucket_int", N_QUERIES, 960,
     _padded(N_POINTS, 8192 * 2), 32, 8192, {}),
    ("ladder build wave", "fused_scan_bucket", 4096, 960,
     _padded(N_POINTS, BUILD_CB), BUILD_LSUB, BUILD_CB, {"is_dot": False}),
)
#: Kernels whose operands are K1's (qc; w2, codes_t).
_K1_OPERANDS = ("fused_scan_bucket_int_packed", "fused_scan_probe")


def _operands(torch, tsk, dev, kernel, b, d, n, lsub, cb, opts):
    """Random operands of one case: int8 codes over the whole range,
    points past N_POINTS as padding (+inf / ineligible), 10% of the
    rest ineligible.  Returns (row operands, shared operands, kwargs):
    the row operands have one row per query."""
    g = torch.Generator(device=dev).manual_seed(b * 7 + n + d)
    qc = torch.randint(-127, 128, (b, d), generator=g, device=dev,
                       dtype=torch.int8)
    codes = torch.randint(-127, 128, (d, n), generator=g, device=dev,
                          dtype=torch.int8)
    norms = torch.rand((1, n), generator=g, device=dev) * 4
    out = torch.rand((1, n), generator=g, device=dev) < 0.1
    out[0, min(n, N_POINTS) if n > N_POINTS else n - n // 16:] = True
    kw = dict(lsub=lsub, cb=cb)
    if kernel in _K1_OPERANDS:
        norms[out] = torch.inf
        w2 = tsk.pack_w2(norms, torch.tensor(2 * 0.011 * 0.019, device=dev),
                         None, lsub=lsub, cb=cb, d=d)
        return (qc,), (w2, codes), dict(kw, **opts)
    if kernel == "fused_scan_bucket_int":
        w = torch.round(norms / (2 * 0.011 * 0.019)).to(torch.int32)
        w[out] = (2**31 - 1) // 2
        return (qc,), (w, codes), kw
    qs = torch.rand((b, 1), generator=g, device=dev) * 0.02 + 1e-3
    scales = torch.rand((1, n), generator=g, device=dev) * 0.02 + 1e-3
    if opts["is_dot"]:
        norms = torch.zeros_like(norms)
    norms[out] = torch.inf
    if kernel == "fused_scan_topt":
        kw["topt"] = TOPT
    return (qc, qs), (codes, scales, norms), dict(kw, **opts)


def _call(tsk, kernel, rows, shared, kw, plain: bool = False):
    """The kernel (or its plain version) on (row operands, shared ones) in
    the wrapper's argument order."""
    fn = getattr(tsk, kernel + ("_plain" if plain else ""))
    if kernel in _K1_OPERANDS + ("fused_scan_bucket_int",):
        return fn(rows[0], shared[0], shared[1], **kw)
    return fn(rows[0], rows[1], *shared, **kw)


def _plain_by_rows(torch, tsk, kernel, rows, shared, kw):
    """The plain version over blocks of query rows, concatenated: rows
    are independent, and a block's [rows, N] matrices fit the card where
    the whole batch's would not."""
    step = max(1, (1 << 28) // shared[-1].shape[1])
    outs = [_call(tsk, kernel, [r[s:s + step] for r in rows], shared, kw,
                  plain=True) for s in range(0, rows[0].shape[0], step)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def _max_err(torch, got, want) -> float:
    """Largest |got - want| over every output (inf where one side is
    infinite and the other is not; equal infinities count 0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for x, y in zip(got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            return float("inf")
        if x.is_floating_point():
            same = (x == y) | (torch.isnan(x) & torch.isnan(y))
            diff = torch.where(same, 0.0, (x - y).abs().nan_to_num(
                nan=float("inf")))
        else:
            diff = (x.long() - y.long()).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def _bound(b, d, n, rows, shared, out):
    """(bound ms, what bounds it) for one call: 2*B*N*D int8 operations
    at the int8 peak, or the inputs read once and outputs written once
    at the HBM rate."""
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in (*rows, *shared,
                                                         *outs))
    t_ops = 2 * b * n * d / PEAK_INT8_OPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _int_mm_ms(torch, qc, codes_t, iters: int) -> float:
    """Device ms of torch._int_mm computing the whole int32 product
    qc @ codes_t, over 65,536-column chunks (the whole [B, N] int32
    product would not fit the card): the library yardstick of K6's "mm"
    mode.  The port never calls it."""
    codes_nd = codes_t.T.contiguous()          # [N, D]: chunks column-major
    step = 65536

    def lib():
        for s in range(0, codes_nd.shape[0], step):
            torch._int_mm(qc, codes_nd[s:s + step].t())

    return _cuda_ms(torch, lib, iters)


def _hold_kernel(torch, tsk, label, kernel, rows, shared, kw,
                 library: bool = False):
    """One kernel at one call: bit-exact against its plain version (over
    blocks of query rows), both timed with CUDA events in turns, its
    TOP/s and its share of the bound printed; with ``library``,
    torch._int_mm on the same product.  Returns its record."""
    b, d = rows[0].shape
    n = shared[-1].shape[1]
    got = _call(tsk, kernel, rows, shared, kw)
    want = _plain_by_rows(torch, tsk, kernel, rows, shared, kw)
    torch.cuda.synchronize()
    err = _max_err(torch, got, want)
    if err != 0:
        raise AssertionError(f"{kernel} {label}: kernel differs from "
                             f"plain by {err}")
    bound_ms, bound_by = _bound(b, d, n, rows, shared, got)
    del got, want
    iters = 3 if b * n > 1 << 32 else 10

    def kern():
        _call(tsk, kernel, rows, shared, kw)

    def plain():
        _plain_by_rows(torch, tsk, kernel, rows, shared, kw)

    # in turns: plain, kernel, kernel, plain
    p1, k1, k2, p2 = (_cuda_ms(torch, f, iters)
                      for f in (plain, kern, kern, plain))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    library_ms = (_int_mm_ms(torch, rows[0], shared[1], iters) if library
                  else None)
    dp4a_ms = DP4A_MS.get((kernel, label))
    _phase("kernels", f"{kernel} {label} B={b} D={d} N={n} "
           f"{kw}: bit-exact; kernel {ms:.4f} ms "
           f"({2 * b * n * d / ms / 1e9:.1f} TOP/s, "
           f"{bound_ms / ms:.2%} of the bound), plain {plain_ms:.4f} ms, "
           f"bound {bound_ms:.4f} ms ({bound_by})"
           + ("" if library_ms is None else
              f", torch._int_mm {library_ms:.4f} ms")
           + ("" if dp4a_ms is None else
              f"; on the __dp4a tile {dp4a_ms:.2f} ms "
              f"({dp4a_ms / ms:.1f}x)")
           + f" [{CARD}]")
    return dict(case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_kernels(torch, tsk, dev):
    """Phase 3.  Returns {kernel: record of its first case}."""
    records = {}
    times = {}
    for label, kernel, b, d, n, lsub, cb, opts in KERNEL_CASES:
        rows, shared, kw = _operands(torch, tsk, dev, kernel, b, d, n, lsub,
                                     cb, opts)
        # the yardstick of K6's record case (torch._int_mm needs D % 8 == 0)
        rec = _hold_kernel(
            torch, tsk, label, kernel, rows, shared, kw,
            library=opts.get("probe") == "mm" and kernel not in records)
        times[(kernel, label)] = rec["ms"]
        records.setdefault(kernel, rec)
        del rows, shared
        torch.cuda.empty_cache()
    mm, mn, full = (times["fused_scan_probe", f"scan batch {p}"]
                    for p in ("mm", "min", "full"))
    k1 = times["fused_scan_bucket_int_packed", "scan batch"]
    _phase("kernels", f"K1 attribution at the ScanIndex batch (K6): product "
           f"{mm:.4f} ms, + min chain {mn - mm:.4f} ms, + key epilogue "
           f"{full - mn:.4f} ms = full {full:.4f} ms; K1 {k1:.4f} ms")
    mm, mn = (times["fused_scan_probe", f"K2 build wave {p}"]
              for p in ("mm", "min"))
    k2 = times["fused_scan_bucket", "build wave"]
    _phase("kernels", f"K2 attribution at the 300-d build wave (K6 at its "
           f"shape): product {mm:.4f} ms, + min chain {mn - mm:.4f} ms, + "
           f"K2's f32 epilogue and argmin {k2 - mn:.4f} ms = K2 {k2:.4f} ms")
    k2, k5 = (times[k, "topt batch"]
              for k in ("fused_scan_bucket", "fused_scan_topt"))
    _phase("kernels", f"K5 attribution at the topt batch (K2 on its "
           f"operands): group minima {k2:.4f} ms, + top-T merge "
           f"{k5 - k2:.4f} ms = K5 {k5:.4f} ms")
    return records


def _random_graph(torch, n: int, k: int, g, dev):
    """[n, k] int32 adjacency of a random valid graph: each row a random
    degree in [1, k] of distinct ids other than its own, ascending,
    -1-terminated (the recipe of tests/test_walk_kernel.py, on the
    card)."""
    x = torch.randint(0, n - 1, (n, k), generator=g, device=dev)
    x = x + (x >= torch.arange(n, device=dev)[:, None]).long()
    x, _ = x.sort(dim=1)
    keep = torch.ones_like(x, dtype=torch.bool)
    keep[:, 1:] = x[:, 1:] != x[:, :-1]
    deg = torch.randint(1, k + 1, (n, 1), generator=g, device=dev)
    keep &= keep.cumsum(1) <= deg
    x, _ = torch.where(keep, x, n).sort(dim=1)
    return torch.where(x < n, x, -1).to(torch.int32)


def _walk_bound(n_exp: int, n_scored: int, k: int, d: int, b: int,
                ef: int):
    """(bound ms, what bounds it) of one K4 call, from this run's work:
    the K ids of each of the n_exp expanded rows and the D codes and
    scale of each of their n_scored valid neighbours (the kernel never
    reads a row's -1 tail), plus the queries and the beams in and out,
    at the HBM rate; or 3 f32 operations per scored neighbour and d at
    the f32 rate."""
    nbytes = (n_exp * k * 4 + n_scored * (d + 4) + b * d * 4
              + 2 * b * ef * 8)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3 * n_scored * d / PEAK_F32_OPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def _walk_plain(torch, wk, args, kw, rows: int = 0, return_work=False):
    """K4's plain version over blocks of ``rows`` queries (all at once
    for 0), concatenated; with ``return_work``, also the expansions and
    valid neighbours summed over the blocks."""
    b = args[0].shape[0]
    step = rows or b
    outs = [wk.walk_search_plain(*(a[s:s + step] for a in args[:3]),
                                 *args[3:], **kw, return_work=return_work)
            for s in range(0, b, step)]
    out = tuple(torch.cat(x) for x in zip(*(o[:2] for o in outs)))
    if return_work:
        out += tuple(sum(o[i] for o in outs) for i in (2, 3))
    return out


def check_walk(torch, wk, what: str, args, kw, iters: int = 3,
               rows: int = 0):
    """K4 against its plain version on the same operands (the plain
    version over blocks of ``rows`` queries when given): bit-exact, both
    timed in turns.  Returns its record."""
    got = wk.walk_search(*args, **kw)
    *want, n_exp, n_scored = _walk_plain(torch, wk, args, kw, rows,
                                         return_work=True)
    torch.cuda.synchronize()
    err = _max_err(torch, got, tuple(want))
    if err != 0:
        raise AssertionError(f"walk_search {what}: kernel differs from "
                             f"plain by {err}")
    b, d = args[0].shape
    k = args[3].shape[1]
    bound_ms, bound_by = _walk_bound(n_exp, n_scored, k, d, b, kw["ef"])
    del got, want

    def kern():
        wk.walk_search(*args, **kw)

    def plain():
        _walk_plain(torch, wk, args, kw, rows)

    p1, k1, k2, p2 = (_cuda_ms(torch, f, iters)
                      for f in (plain, kern, kern, plain))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    _phase("kernels", f"walk_search {what} B={b} D={d} {kw}: bit-exact; "
           f"{n_exp} expansions, {n_scored} valid neighbours "
           f"({n_scored / max(1, n_exp * k):.4f} of the slots); kernel "
           f"{ms:.4f} ms ({bound_ms / ms:.2%} of the bound), plain "
           f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
           f"[{CARD}]")
    return dict(case=what, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_walk(torch, dev):
    """Phase 3, K4: a random valid graph of WALK_N nodes at D 128 and
    300, seed-scan beams, expand 1 and 2.  Returns the record of the
    serving setting's case (D 128, expand 2)."""
    from instant_distance_tpu_torch.ops import packed as pk
    from instant_distance_tpu_torch.ops import walk_kernel as wk

    record = None
    for d in (DIM, DIM300):
        g = torch.Generator(device=dev).manual_seed(d)
        pts = torch.randn((WALK_N, d), generator=g, device=dev)
        zero = pk.pack_layer(_random_graph(torch, WALK_N, WALK_K, g, dev),
                             *pk.quantize_points(pts))
        queries = torch.randn((WALK_B, d), generator=g, device=dev)
        beams = pk.seeded_beam(queries, pts[:WALK_S].to(torch.bfloat16),
                               WALK_EF)
        args = (queries, *beams, *zero)
        for expand in wk.EXPANDS:
            kw = dict(expand=expand, ef=WALK_EF, max_iters=8 * WALK_EF + 16)
            rec = check_walk(torch, wk, "random graph", args, kw)
            if d == DIM and expand == PACKED_KW["expand"]:
                record = rec
        del pts, zero, queries, beams, args
        torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

class Launches:
    """Kernel launches per path: each path runs with every count set to 0
    just before it and read just after; beside them the point-major code
    copies the path made (``scan_kernel.point_major``: one per index or
    build operands, none per call)."""

    def __init__(self, tsk):
        self.tsk = tsk
        self.paths = {}
        self.copies = {}

    def run(self, path: str, fn):
        for name in self.tsk.launches:
            self.tsk.launches[name] = 0
        made = self.tsk.point_major_copies
        out = fn()
        self.paths[path] = dict(self.tsk.launches)
        self.copies[path] = self.tsk.point_major_copies - made
        return out

    def total(self, kernel: str) -> int:
        return sum(counts[kernel] for counts in self.paths.values())

    def need(self, path: str, kernels, absent=()) -> None:
        counts = self.paths[path]
        for k in kernels:
            if counts[k] < 1:
                raise AssertionError(f"{path}: {k} was not launched")
        for k in absent:
            if counts[k]:
                raise AssertionError(f"{path}: {k} ran {counts[k]} times")


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


def _check_recall(recs, what: str) -> None:
    if min(recs) < RECALL_FLOOR:
        raise AssertionError(f"{what} recall {min(recs)} < {RECALL_FLOOR}")


def _scan(torch, launches, path, index, queries, gt, kw, tag=""):
    """One ScanIndex path: a checked batch, then the timed repeats."""
    def run():
        d, i = index.search_batch(queries, **kw)
        _check_results(torch, d, i, queries.shape[0], path)
        recs = _recall_blocks(i[:N_BLOCKS * BLOCK].cpu(), gt)
        t = _wall_s(torch, lambda: index.search_batch(queries, **kw))
        return recs, t, (d, i)

    recs, t, result = launches.run(path, run)
    _phase(path, f"{kw}: {queries.shape[0] / t:.1f} qps "
           f"({t * 1e3:.2f} ms/batch of {queries.shape[0]}), recall@10 "
           f"blocks {[round(r, 4) for r in recs]}, launches "
           f"{ {k: v for k, v in launches.paths[path].items() if v} }"
           + (f" [{tag}]" if tag else ""))
    _check_recall(recs, path)
    return result


def _build_path(torch, launches, path, build):
    """One index build path: (index, build seconds, peak GiB)."""
    marks = {}
    t0 = time.perf_counter()

    def progress(done, total, phase):
        step = done * 10 // total
        if step not in marks:
            marks[step] = time.perf_counter()
            print(f"  {path} {done}/{total} ({phase}) at "
                  f"{marks[step] - t0:.1f} s", file=sys.stderr, flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = launches.run(path, lambda: build(progress))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    return index, build_s, peak_gib


def _search_path(torch, idt, launches, path, index, queries):
    """search_batch(ef=50) on a built index: (recall blocks, seconds per
    BLOCK-query batch)."""
    nq = N_BLOCKS * BLOCK
    gt = idt.BruteForce(index.points).search_batch(queries[:nq], K)[1].cpu()

    def run():
        d, p = index.search_batch(queries[:nq], k=K, ef=50)
        _check_results(torch, d, p, nq, path)
        recs = _recall_blocks(p.cpu(), gt)
        t = _wall_s(torch, lambda: index.search_batch(queries[:BLOCK], k=K,
                                                      ef=50))
        return recs, t

    return launches.run(path + " search", run)


def _attribution(torch, tsk, launches, pts, queries):
    """The attribution path: K6's three modes on the 1M x 128 ScanIndex
    batch's own K1 operands (what ``bucket_pack`` builds), timed beside
    K1 itself."""
    lsub, cb, inner = SCAN_KW["lsub"], SCAN_KW["cb"], SCAN_KW["inner"]
    codes_t, norms_r, sg = tsk.pack_operands(pts, cb * inner)
    qc, qs = tsk.quantize_batch(queries)
    w2 = tsk.pack_w2(norms_r, 2.0 * qs * sg, None, lsub=lsub, cb=cb,
                     d=pts.shape[1])

    def run():
        ms = {p: _cuda_ms(torch, lambda: tsk.fused_scan_probe(
            qc, w2, codes_t, lsub=lsub, cb=cb, inner=inner, probe=p), 3)
            for p in ("mm", "min", "full")}
        ms["K1"] = _cuda_ms(torch, lambda: tsk.fused_scan_bucket_int_packed(
            qc, w2, codes_t, lsub=lsub, cb=cb), 3)
        return ms

    ms = launches.run("scan attribution", run)
    launches.need("scan attribution", ["fused_scan_probe"])
    _phase("scan attribution", f"B={qc.shape[0]} N={codes_t.shape[1]}: "
           f"product {ms['mm']:.4f} ms, + min chain "
           f"{ms['min'] - ms['mm']:.4f} ms, + key epilogue "
           f"{ms['full'] - ms['min']:.4f} ms = full {ms['full']:.4f} ms; "
           f"K1 {ms['K1']:.4f} ms")


def _packed_path(torch, idt, launches, path, index, queries, *,
                 plain_route: bool):
    """The serving flow on a built index: PackedHnsw.from_index, then
    search_batch_kernel (K4) on the whole query batch, once more with
    merge="extract" (the JAX package's default name, the same kernel),
    K4 against its plain version at that very call and, with
    ``plain_route``, the plain-op search_batch at the same settings.
    Returns (packed index, K4's record at that call)."""
    from instant_distance_tpu_torch.ops import packed as pk
    from instant_distance_tpu_torch.ops import walk_kernel as wk

    nq = N_BLOCKS * BLOCK
    gt = idt.BruteForce(index.points).search_batch(queries[:nq], K)[1].cpu()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed = idt.PackedHnsw.from_index(index)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    codes_gb = packed.zero_pack[1].numel() / 1e9
    _phase(path, f"from_index {len(packed)}x{packed.points.shape[1]} "
           f"K={packed.zero_pack[0].shape[1]}: {pack_s:.2f} s, nbytes "
           f"{packed.nbytes() / 1e9:.2f} GB ({codes_gb:.2f} GB zero-layer "
           f"codes), peak memory {peak:.2f} GiB")

    def serve(route, **kw):
        def run():
            d, p = route(queries, **PACKED_KW, **kw)
            _check_results(torch, d, p, queries.shape[0], path)
            recs = _recall_blocks(p[:nq].cpu(), gt)
            t = _wall_s(torch, lambda: route(queries, **PACKED_KW, **kw), 3)
            return recs, t

        name = " ".join([path, route.__name__, *kw.values()])
        recs, t = launches.run(name, run)
        _phase(path, f"{route.__name__}({kw} {PACKED_KW}) batch "
               f"{queries.shape[0]}: {queries.shape[0] / t:.1f} qps "
               f"({t * 1e3:.2f} ms/batch), recall@10 blocks "
               f"{[round(r, 4) for r in recs]}")
        _check_recall(recs, name)
        return name

    launches.need(serve(packed.search_batch_kernel), ["walk_search"])
    launches.need(serve(packed.search_batch_kernel, merge="extract"),
                  ["walk_search"])
    if plain_route:
        launches.need(serve(packed.search_batch), [], absent=["walk_search"])
    ef = PACKED_KW["ef"]
    beams = pk.seeded_beam(
        queries, packed.points[:PACKED_KW["entry_seeds"]].to(torch.bfloat16),
        ef)
    record = check_walk(
        torch, wk, f"{path} call", (queries, *beams, *packed.zero_pack),
        dict(expand=PACKED_KW["expand"], ef=ef,
             max_iters=index.config.max_iter_factor * ef + 16))
    return packed, record


# ---------------------------------------------------------------------------
# phases 10-13: construction beyond the default build, and add
# ---------------------------------------------------------------------------

def _peak_gib(torch) -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def _timed(torch, fn):
    """(fn(), host seconds, peak GiB) with the device synced around it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _peak_gib(torch)


def _report_build(torch, idt, launches, path, index, queries, n, build_s,
                  peak):
    """search_batch(ef=50) of a built index against BruteForce over its
    points; prints the build and search lines and gates recall."""
    recs, t = _search_path(torch, idt, launches, path, index, queries)
    _phase(path, f"build {n}x{index.points.shape[1]}: {build_s:.1f} s "
           f"({n / build_s:.1f} pts/s), peak memory {peak:.2f} GiB, "
           f"reverse drops {index.reverse_drops}; search ef=50 batch "
           f"{BLOCK}: {BLOCK / t:.1f} qps, recall@10 blocks "
           f"{[round(r, 4) for r in recs]}")
    _check_recall(recs, path)
    return recs


def phase_add(torch, idt, launches, pts, queries, gt, one_shot, hnsw_recs,
              base_file):
    """Phase 10: grow an index and a ScanIndex by add (K1), serve the
    grown index packed (K4).  The base index is dumped to ``base_file``
    before it grows (the streaming phase loads it)."""
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50)
    t_wall = time.perf_counter()
    (index, ids), build_s, peak = _build_path(
        torch, launches, "add base",
        lambda progress: idt.Hnsw.build(pts[:ADD_BASE], cfg,
                                        progress=progress))
    launches.need("add base", ["fused_scan_bucket_int_packed"])
    t0 = time.perf_counter()
    index.dump(base_file)
    _phase("add", f"base dumped for the streaming phase: "
           f"{os.path.getsize(base_file) / 1e9:.2f} GB in "
           f"{time.perf_counter() - t0:.2f} s")
    step = (N_POINTS - ADD_BASE) // ADD_CALLS

    def grow():
        return np.concatenate([
            index.add(pts[ADD_BASE + c * step:ADD_BASE + (c + 1) * step])
            for c in range(ADD_CALLS)])

    pids, add_s, add_peak = _timed(torch, lambda: launches.run("add", grow))
    launches.need("add", ["fused_scan_bucket_int_packed"])
    if not np.array_equal(pids, np.arange(ADD_BASE, N_POINTS)):
        raise AssertionError("add: the new pids do not count up from "
                             f"{ADD_BASE}")
    if index.reverse_drops:
        raise AssertionError(f"add: {index.reverse_drops} reverse drops")
    # the truth is in row numbers: base rows map through the build's ids,
    # added rows to their new pids
    truth = np.concatenate([ids, pids])[gt.numpy()]
    nq = N_BLOCKS * BLOCK

    def search():
        d, p = index.search_batch(queries[:nq], k=K, ef=50)
        _check_results(torch, d, p, nq, "add")
        return _recall_blocks(p.cpu(), truth), _wall_s(
            torch, lambda: index.search_batch(queries[:BLOCK], k=K, ef=50))

    recs, t = launches.run("add search", search)
    _phase("add", f"base build {ADD_BASE}x{DIM}: {build_s:.1f} s "
           f"({ADD_BASE / build_s:.1f} pts/s), peak memory {peak:.2f} GiB; "
           f"add {N_POINTS - ADD_BASE} in {ADD_CALLS} calls: {add_s:.2f} s "
           f"({(N_POINTS - ADD_BASE) / add_s:.1f} pts/s), peak memory "
           f"{add_peak:.2f} GiB, reverse drops 0; search ef=50 batch "
           f"{BLOCK}: {BLOCK / t:.1f} qps, recall@10 blocks "
           f"{[round(r, 4) for r in recs]} (one-shot hnsw: "
           f"{[round(r, 4) for r in hnsw_recs]}); launches "
           f"{ {k: v for k, v in launches.paths['add'].items() if v} }")
    _check_recall(recs, "add")
    packed, _ = _packed_path(torch, idt, launches, "add packed", index,
                             queries, plain_route=False)
    del packed, index

    def grown_scan():
        scan = idt.ScanIndex(pts[:ADD_BASE])
        scan.add(pts[ADD_BASE:])
        return scan.search_batch(queries, **SCAN_KW)

    (d, i), scan_s, scan_peak = _timed(
        torch, lambda: launches.run("add scan", grown_scan))
    launches.need("add scan", ["fused_scan_bucket_int_packed"])
    if not (torch.equal(d, one_shot[0]) and torch.equal(i, one_shot[1])):
        raise AssertionError("add scan: the grown ScanIndex's results "
                             "differ from the one-shot ScanIndex's")
    _phase("add", f"ScanIndex({ADD_BASE}).add({N_POINTS - ADD_BASE}) then "
           f"bucket_pack batch {queries.shape[0]}: {scan_s:.2f} s, peak "
           f"memory {scan_peak:.2f} GiB; (d, i) equal to the one-shot "
           f"ScanIndex's bit for bit; wall {time.perf_counter() - t_wall:.1f} "
           "s")
    torch.cuda.empty_cache()


def phase_beam(torch, idt, launches, pts, queries):
    """Phase 11: a callable-metric build (beam waves, no kernel) and an
    extend_candidates build (K1)."""
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50,
                     metric=lambda a, b: ((a - b) ** 2).sum())
    t_wall = time.perf_counter()
    (index, _), build_s, peak = _build_path(
        torch, launches, "beam",
        lambda progress: idt.Hnsw.build(pts[:BEAM_N], cfg,
                                        progress=progress))
    launches.need("beam", [], absent=list(KERNELS))
    _report_build(torch, idt, launches, "beam", index, queries, BEAM_N,
                  build_s, peak)
    del index
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50,
                     heuristic=idt.Heuristic(extend_candidates=True))
    (index, _), build_s, peak = _build_path(
        torch, launches, "beam extend",
        lambda progress: idt.Hnsw.build(pts[:EXTEND_N], cfg,
                                        progress=progress))
    launches.need("beam extend", ["fused_scan_bucket_int_packed"])
    _report_build(torch, idt, launches, "beam extend", index, queries,
                  EXTEND_N, build_s, peak)
    _phase("beam", f"wall {time.perf_counter() - t_wall:.1f} s")
    del index
    torch.cuda.empty_cache()


class _Stop(RuntimeError):
    """Raised from a build's progress callback to stop it."""


def _same_graph(torch, a, b) -> bool:
    return (torch.equal(a.zero, b.zero) and len(a.layers) == len(b.layers)
            and all(torch.equal(x, y) for x, y in zip(a.layers, b.layers)))


def phase_checkpoint(torch, idt, launches, pts, queries):
    """Phase 12: builds A, A again, B stopped halfway with a checkpoint,
    C resumed from it; C must equal A bit for bit."""
    from instant_distance_tpu_torch.ops import construct

    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50,
                     construct_exact_prefix=CKPT_PREFIX)
    sub = pts[:CKPT_N]
    t_wall = time.perf_counter()
    (a, a_ids), build_s, peak = _build_path(
        torch, launches, "checkpoint A",
        lambda progress: idt.Hnsw.build(sub, cfg, progress=progress))
    launches.need("checkpoint A", ["fused_scan_bucket_int_packed"])
    (a2, a2_ids), _, _ = _build_path(
        torch, launches, "checkpoint A again",
        lambda progress: idt.Hnsw.build(sub, cfg, progress=progress))
    if not (np.array_equal(a_ids, a2_ids) and _same_graph(torch, a, a2)):
        raise AssertionError("checkpoint: two builds of A differ (the "
                             "build is not deterministic)")
    del a2

    def stop(done, total, phase):
        if done >= total // 2:
            raise _Stop(done)

    # each save's seconds, from a timing wrapper around the build's save
    saves, save = [], construct._save_ckpt

    def timed_save(*args):
        t0 = time.perf_counter()
        save(*args)
        saves.append(time.perf_counter() - t0)

    construct._save_ckpt = timed_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fname = os.path.join(tmp, "build.ckpt.npz")
            t0 = time.perf_counter()
            try:
                launches.run("checkpoint B", lambda: idt.Hnsw.build(
                    sub, cfg, progress=stop, checkpoint=fname,
                    checkpoint_every=CKPT_EVERY))
                raise AssertionError("checkpoint: build B was not stopped")
            except _Stop:
                pass
            b_s, b_saves = time.perf_counter() - t0, len(saves)
            size_mb = os.path.getsize(fname) / 1e6
            (c, c_ids), c_s, c_peak = _build_path(
                torch, launches, "checkpoint C",
                lambda progress: idt.Hnsw.build(
                    sub, cfg, progress=progress, checkpoint=fname,
                    checkpoint_every=CKPT_EVERY))
            left = os.path.exists(fname)
    finally:
        construct._save_ckpt = save
    launches.need("checkpoint C", ["fused_scan_bucket_int_packed"])
    if left:
        raise AssertionError("checkpoint: the file outlived the build")
    if not (np.array_equal(a_ids, c_ids) and _same_graph(torch, a, c)):
        raise AssertionError("checkpoint: resumed build C differs from A")
    _phase("checkpoint", f"A {build_s:.1f} s ({CKPT_N / build_s:.1f} pts/s, "
           f"peak {peak:.2f} GiB), A again identical; B stopped at half in "
           f"{b_s:.1f} s; file {size_mb:.1f} MB; saves every {CKPT_EVERY} "
           f"waves, seconds each: B "
           f"{[round(x, 3) for x in saves[:b_saves]]}, C "
           f"{[round(x, 3) for x in saves[b_saves:]]}; C resumed in "
           f"{c_s:.1f} s (peak {c_peak:.2f} GiB): ids, zero layer and "
           f"{len(c.layers)} upper layers equal A's bit for bit; file "
           "removed")
    _report_build(torch, idt, launches, "checkpoint", c, queries, CKPT_N,
                  build_s, peak)
    _phase("checkpoint", f"wall {time.perf_counter() - t_wall:.1f} s")
    del a, c
    torch.cuda.empty_cache()


def phase_sampled(torch, idt, launches, dev):
    """Phase 13: the sampled build at DEEP's width (K1 on the capped
    columns, the repair in the commit)."""
    from instant_distance_tpu_torch.utils.datasets import synthetic_clustered

    t0 = time.perf_counter()
    data = synthetic_clustered(DEEP_N + N_QUERIES, DEEP_DIM,
                               n_clusters=10000, seed=9)
    pts = torch.from_numpy(data[:DEEP_N]).to(dev)
    queries = torch.from_numpy(data[DEEP_N:]).to(dev)
    del data
    _phase("data", f"{DEEP_N + N_QUERIES}x{DEEP_DIM} clustered, "
           f"{time.perf_counter() - t0:.1f} s")
    cfg = idt.Config(seed=9, m=32, wave_size=4096, ef_search=50,
                     construct_sample_cols=SAMPLE_COLS,
                     construct_split=True)
    (index, _), build_s, peak = _build_path(
        torch, launches, "sampled",
        lambda progress: idt.Hnsw.build(pts, cfg, progress=progress))
    launches.need("sampled", ["fused_scan_bucket_int_packed"])
    _report_build(torch, idt, launches, "sampled", index, queries, DEEP_N,
                  build_s, peak)
    _phase("sampled", f"wall {time.perf_counter() - t0:.1f} s")
    del index, pts, queries
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the last modules: the RefHnsw oracle, the examples and the dataset ladder
# ---------------------------------------------------------------------------

def phase_oracle(torch, idt, launches, dev):
    """The sequential oracle (``utils/refimpl.RefHnsw``) built on the host
    at tests/test_beam_vs_oracle.py:60-76's data and config; the port's
    batched ``hnsw_search`` on the card over that graph must return the
    oracle's pid lists exactly (distances within 1e-5 relative).  The
    same points built by the card's waves must reach the oracle graph's
    recall@10, less ORACLE_SLACK."""
    from instant_distance_tpu_torch.ops.beam import hnsw_search
    from instant_distance_tpu_torch.ops.distance import resolve
    from instant_distance_tpu_torch.utils.metrics import recall_at_k
    from instant_distance_tpu_torch.utils.refimpl import RefHnsw

    rng = np.random.default_rng(ORACLE_SEED)
    pts = rng.standard_normal((ORACLE_N, ORACLE_DIM)).astype(np.float32)
    queries = rng.standard_normal((ORACLE_Q, ORACLE_DIM)).astype(np.float32)
    more = np.random.default_rng(ORACLE_SEED + 1).standard_normal(
        (ORACLE_RECALL_Q, ORACLE_DIM)).astype(np.float32)
    cfg = idt.Config(seed=ORACLE_SEED, metric="sqeuclidean")
    t0 = time.perf_counter()
    ref = RefHnsw(pts, cfg)
    ref_s = time.perf_counter() - t0

    def search(q):
        d, p = hnsw_search(
            torch.from_numpy(q).to(dev), torch.from_numpy(ref.zero).to(dev),
            tuple(torch.from_numpy(a).to(dev) for a in reversed(ref.layers)),
            torch.from_numpy(ref.points).to(dev), resolve(cfg.metric),
            ef=ORACLE_EF, m=cfg.m, zero_links=cfg.m0)
        return d.cpu().numpy(), p.cpu().numpy()

    d, p = launches.run("oracle search", lambda: search(queries))
    for i, q in enumerate(queries):
        oracle = ref.search(q, ef=ORACLE_EF)
        if p[i, :len(oracle)].tolist() != [pid for _, pid in oracle]:
            raise AssertionError(f"oracle: query {i}'s pids differ from "
                                 "RefHnsw.search's")
        np.testing.assert_allclose(
            d[i, :len(oracle)], np.array([x for x, _ in oracle], np.float32),
            rtol=1e-5, err_msg=f"oracle: query {i}")
    ref_rec = recall_at_k(search(more)[1][:, :K], idt.BruteForce(
        ref.points, device=dev).search_batch(more, K)[1].cpu().numpy(), K)
    (index, _), build_s, _ = _build_path(
        torch, launches, "oracle wave build",
        lambda progress: idt.Hnsw.build(pts, cfg, device=dev))
    launches.need("oracle wave build", ["fused_scan_bucket_int_packed"])
    wave_rec = recall_at_k(
        index.search_batch(more, k=K, ef=ORACLE_EF)[1].cpu().numpy(),
        idt.BruteForce(index.points).search_batch(more, K)[1].cpu().numpy(),
        K)
    _phase("oracle", f"RefHnsw {ORACLE_N}x{ORACLE_DIM} (M {cfg.m}, "
           f"ef_construction {cfg.ef_construction}, {len(ref.layers)} upper "
           f"layers) on the host in {ref_s:.1f} s; hnsw_search ef "
           f"{ORACLE_EF} on the card over its graph: {ORACLE_Q} queries' "
           f"pid lists equal RefHnsw.search's, distances within 1e-5; "
           f"recall@10 over {ORACLE_RECALL_Q} queries: oracle graph "
           f"{ref_rec:.4f}, the card's wave build ({build_s:.2f} s) "
           f"{wave_rec:.4f}")
    if wave_rec < ref_rec - ORACLE_SLACK:
        raise AssertionError(f"oracle: the wave build's recall {wave_rec} "
                             f"< the oracle graph's {ref_rec} - "
                             f"{ORACLE_SLACK}")


class _ExampleRun:
    """One example as a subprocess, its output in a file; a thread waits
    for it and notes when it ended, so its wall time is its own while
    the smoke does other work."""

    def __init__(self, argv, log, cwd, env):
        self.out = open(log, "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, stdout=self.out,
                                     stderr=subprocess.STDOUT, text=True,
                                     cwd=cwd, env=env)
        self.t1 = None
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self):
        self.proc.wait()
        self.t1 = time.perf_counter()

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()


def start_examples(idt_root, tmp):
    """Start the port's four examples as a user runs them (``python -m``,
    the default device: the card), all at once; returns what
    :func:`phase_examples` waits for."""
    env = dict(os.environ, PYTHONPATH=idt_root)
    index = os.path.join(tmp, "translate.idx.npz")

    def start(module, args):
        argv = [sys.executable, "-m",
                f"instant_distance_tpu_torch.examples.{module}", *args]
        if module == "translate":
            argv += ["--index", index]
        return _ExampleRun(argv, os.path.join(tmp, "-".join([module, *args])
                                              + ".log"), idt_root, env)

    return start, {m: start(m, a) for m, a, _ in EXAMPLES}


def _wait_examples(runs, want) -> dict:
    """Wait for every run; check its exit code and that its output holds
    ``want[name]``.  Returns {name: (output, seconds)}."""
    deadline = time.perf_counter() + 600
    results = {}
    for name, run in runs.items():
        run.watcher.join(max(0.0, deadline - time.perf_counter()))
        if run.t1 is None:
            raise AssertionError(f"example {name}: still running after "
                                 "600 s")
        run.out.seek(0)
        text = run.out.read()
        missing = [w for w in want[name] if w not in text]
        if run.proc.returncode != 0 or missing:
            raise AssertionError(f"example {name}: exit "
                                 f"{run.proc.returncode}, missing {missing}"
                                 f"\n{text[-3000:]}")
        results[name] = (text, run.t1 - run.t0)
    return results


def stop_examples(started) -> None:
    """Kill whatever of :func:`start_examples`' runs still runs."""
    for run in started[1].values():
        run.stop()


def phase_examples(started) -> None:
    """The four examples (started by :func:`start_examples`) end with exit
    code 0 and print the lines tests/test_examples.py checks of the JAX
    examples (colors exactly ``red``); then translate runs again and
    loads the first run's dump (it builds nothing)."""
    start, runs = started
    try:
        want = {m: w for m, _, w in EXAMPLES}
        results = _wait_examples(runs, want)
        again = "translate word9_en"
        runs[again] = start("translate", ["word9_en"])
        text, secs = _wait_examples({again: runs[again]},
                                    {again: ["word9"]})[again]
    finally:
        stop_examples(started)
    if results["colors"][0].strip() != "red":
        raise AssertionError(f"example colors: {results['colors'][0]!r}")
    if "building index" in text:
        raise AssertionError("example translate: the second run rebuilt "
                             f"the index\n{text[-2000:]}")
    for module, (out, secs_m) in results.items():
        lines = [next(ln.strip() for ln in out.splitlines() if w in ln)
                 for w in want[module]]
        _phase("examples", f"{module}: exit 0 in {secs_m:.1f} s; "
               + " | ".join(lines))
    _phase("examples", f"translate word9_en again, loading the dump: exit 0 "
           f"in {secs:.1f} s; "
           + next(ln.strip() for ln in text.splitlines() if "word9" in ln)
           + f" [{CARD}; {HOST}]")


def _ladder_recall(found, truth) -> float:
    from instant_distance_tpu_torch.utils.metrics import recall_at_k

    return recall_at_k(np.asarray(found.cpu()), truth, K)


def phase_ladder(torch, idt, tsk, launches, dev):
    """BASELINE.md's GIST1M rung at full size (``load_config("gist1m")``:
    1M x 960 synthetic clustered points and 10,000 queries), the first
    N_QUERIES queries as one block: ScanIndex bucket_pack at lsub 16 (K1
    at D = 960) and 32 (K3), Hnsw.build (K2 every wave), search_batch,
    PackedHnsw.from_index and search_batch_kernel (K4), each with
    recall@10 against BruteForce.  K1 and K3 are held against their
    plain versions on the scan's own operands, K2 on random operands of
    a build wave's shape (as in phase 3), K4 at the packed call (its
    plain version LADDER_ROWS queries at a time)."""
    from instant_distance_tpu_torch.models.scan import _int32_saturating
    from instant_distance_tpu_torch.ops import packed as pk
    from instant_distance_tpu_torch.ops import walk_kernel as wk
    from instant_distance_tpu_torch.utils.datasets import load_config

    t_wall = time.perf_counter()
    data, queries = load_config("gist1m")
    pts = torch.from_numpy(data).to(dev)
    queries = torch.from_numpy(queries[:N_QUERIES]).to(dev)
    n, d = data.shape
    del data
    gt = idt.BruteForce(pts).search_batch(queries, K)[1].cpu().numpy()
    _phase("ladder", f"load_config('gist1m'): {n}x{d} points and "
           f"{queries.shape[0]} of its 10,000 queries (clustered, "
           f"{max(100, n // 1000)} clusters), truth from BruteForce: "
           f"{time.perf_counter() - t_wall:.1f} s")
    scan = idt.ScanIndex(pts)
    for lsub, kernel, other in ((16, "fused_scan_bucket_int_packed",
                                 "fused_scan_bucket_int"),
                                (32, "fused_scan_bucket_int",
                                 "fused_scan_bucket_int_packed")):
        path = f"ladder scan lsub {lsub}"
        kw = dict(LADDER_SCAN_KW, lsub=lsub)

        def run():
            dd, i = scan.search_batch(queries, **kw)
            _check_results(torch, dd, i, queries.shape[0], path)
            return _ladder_recall(i, gt), _wall_s(
                torch, lambda: scan.search_batch(queries, **kw), 3)

        rec, t = launches.run(path, run)
        launches.need(path, [kernel], absent=[other])
        _phase("ladder", f"ScanIndex {kw}: {kernel}, {queries.shape[0] / t:.1f}"
               f" qps ({t * 1e3:.2f} ms/batch of {queries.shape[0]}), "
               f"recall@10 {rec:.4f} [{CARD}]")
        _check_recall([rec], path)
    cb = LADDER_SCAN_KW["cb"]
    codes_t, norms_r, sg = scan._fused_int_arrays(cb * LADDER_SCAN_KW["inner"])
    qc, qs = tsk.quantize_batch(queries)
    denom = 2.0 * qs * sg
    w2 = tsk.pack_w2(norms_r, denom, None, lsub=16, cb=cb, d=d)
    _hold_kernel(torch, tsk, "ladder scan lsub 16",
                 "fused_scan_bucket_int_packed", (qc,), (w2, codes_t),
                 dict(lsub=16, cb=cb))
    del w2
    w = torch.where(torch.isfinite(norms_r),
                    _int32_saturating(torch.round(norms_r / denom)),
                    (2**31 - 1) // 2)
    _hold_kernel(torch, tsk, "ladder scan lsub 32", "fused_scan_bucket_int",
                 (qc,), (w, codes_t), dict(lsub=32, cb=cb))
    del scan, codes_t, norms_r, w, qc
    label, kernel, b, d_w, n_w, lsub, cb, opts = LADDER_CASES[2]
    rows, shared, kw = _operands(torch, tsk, dev, kernel, b, d_w, n_w, lsub,
                                 cb, opts)
    _hold_kernel(torch, tsk, label, kernel, rows, shared, kw)
    del rows, shared
    torch.cuda.empty_cache()

    cfg = idt.Config(seed=0, m=32, wave_size=4096, ef_search=50)
    (index, ids), build_s, peak = _build_path(
        torch, launches, "ladder hnsw",
        lambda progress: idt.Hnsw.build(pts, cfg, progress=progress))
    launches.need("ladder hnsw", ["fused_scan_bucket"],
                  absent=["fused_scan_bucket_int_packed"])
    truth = ids[gt]

    def search():
        dd, p = index.search_batch(queries, k=K, ef=50)
        _check_results(torch, dd, p, queries.shape[0], "ladder hnsw")
        return _ladder_recall(p, truth), _wall_s(
            torch, lambda: index.search_batch(queries, k=K, ef=50), 1)

    rec, t = launches.run("ladder hnsw search", search)
    _phase("ladder", f"Hnsw.build {n}x{d} m=32 wave 4096: {build_s:.1f} s "
           f"({n / build_s:.1f} pts/s), peak memory {peak:.2f} GiB, reverse "
           f"drops {index.reverse_drops}, launches "
           f"{ {k: v for k, v in launches.paths['ladder hnsw'].items() if v} }"
           f"; search_batch ef=50 batch {queries.shape[0]}: "
           f"{queries.shape[0] / t:.1f} qps, recall@10 {rec:.4f} [{CARD}]")
    _check_recall([rec], "ladder hnsw")

    # the packed form: decide from the arithmetic whether it fits
    del pts
    torch.cuda.empty_cache()
    k0 = index.zero.shape[1]
    need = (n * k0 * (d + 4) + n * d
            + sum(l.shape[0] * l.shape[1] * (d + 4) for l in index.layers)
            + LADDER_HEADROOM)
    free, total = torch.cuda.mem_get_info()
    _phase("ladder", f"before from_index: mem_get_info free {free / 1e9:.2f}"
           f" GB of {total / 1e9:.2f} GB; the packed form needs "
           f"{need / 1e9:.2f} GB ([{n}, {k0}, {d}] int8 codes, their scales,"
           f" the upper layers, the points' codes, "
           f"{LADDER_HEADROOM / 1e9:.1f} GB for the searches)")
    if need > free:
        del index
        torch.cuda.empty_cache()
        data, q2 = load_config("gist1m", n=LADDER_PACKED_FALLBACK)
        queries = torch.from_numpy(q2[:N_QUERIES]).to(dev)
        pts = torch.from_numpy(data).to(dev)
        n = data.shape[0]
        del data
        gt = idt.BruteForce(pts).search_batch(queries, K)[1].cpu().numpy()
        (index, ids), build_s, peak = _build_path(
            torch, launches, "ladder hnsw (packed)",
            lambda progress: idt.Hnsw.build(pts, cfg, progress=progress))
        truth = ids[gt]
        del pts
        _phase("ladder", f"the packed form does not fit at 1M: packed route "
               f"on load_config('gist1m', n={n}) (built in {build_s:.1f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed = idt.PackedHnsw.from_index(index)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    pack_peak = _peak_gib(torch)

    def serve():
        dd, p = packed.search_batch_kernel(queries, **PACKED_KW)
        _check_results(torch, dd, p, queries.shape[0], "ladder packed")
        return _ladder_recall(p, truth), _wall_s(
            torch, lambda: packed.search_batch_kernel(queries, **PACKED_KW),
            3)

    rec, t = launches.run("ladder packed", serve)
    launches.need("ladder packed", ["walk_search"])
    _phase("ladder", f"PackedHnsw.from_index {n}x{d} K={k0}: {pack_s:.2f} s, "
           f"nbytes {packed.nbytes() / 1e9:.2f} GB, peak memory "
           f"{pack_peak:.2f} GiB; search_batch_kernel({PACKED_KW}) batch "
           f"{queries.shape[0]}: {queries.shape[0] / t:.1f} qps "
           f"({t * 1e3:.2f} ms/batch), recall@10 {rec:.4f} [{CARD}]")
    _check_recall([rec], "ladder packed")
    ef = PACKED_KW["ef"]
    beams = pk.seeded_beam(
        queries, packed.points[:PACKED_KW["entry_seeds"]].to(torch.bfloat16),
        ef)
    walk_kw = dict(expand=PACKED_KW["expand"], ef=ef,
                   max_iters=cfg.max_iter_factor * ef + 16)
    check_walk(torch, wk, "ladder packed call",
               (queries, *beams, *packed.zero_pack), walk_kw,
               rows=LADDER_ROWS)
    del packed, index, beams, queries
    torch.cuda.empty_cache()
    _phase("ladder", f"wall {time.perf_counter() - t_wall:.1f} s")


# ---------------------------------------------------------------------------
# the serving surface: grouped scan selection, HybridIndex, the host
# engine, StreamingHnsw and the CLI
# ---------------------------------------------------------------------------

def phase_scan_groups(torch, launches, scan, queries, gt):
    """ScanIndex bucket_pack with sel_kgroup (K1 with groups) and with
    sel_group (a grouped min over K1's keys)."""
    for path, kw in (("scan kgroup", KGROUP_KW), ("scan group", GROUP_KW)):
        _scan(torch, launches, path, scan, queries, gt, kw, tag=CARD)
        launches.need(path, ["fused_scan_bucket_int_packed"])


def _p50_ms(torch, fn, n: int) -> float:
    """Median host milliseconds of fn(i) for i < n, each ended by a device
    sync."""
    fn(0)
    torch.cuda.synchronize()
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return float(np.median(lat) * 1e3)


def phase_hybrid(torch, idt, launches, index, queries):
    """HybridIndex over the 1M x 128 graph with a ScanIndex of its points
    (pid order) as the device route: the lift, host qps on all cores,
    single-query p50 on each route, calibrate, and the routing gates."""
    from instant_distance_tpu_torch import native

    if not native.available():
        raise AssertionError(f"hybrid: no host engine: {native.load_error()}")
    nq = N_BLOCKS * BLOCK
    gt = idt.BruteForce(index.points).search_batch(queries[:nq], K)[1].cpu()
    scan = idt.ScanIndex.from_index(index)
    q_np = queries.cpu().numpy()
    t0 = time.perf_counter()
    hyb = idt.HybridIndex(index, tpu_index=scan)
    lift_s = time.perf_counter() - t0
    if not hyb.host_available:
        raise AssertionError(f"hybrid: no host engine: {native.load_error()}")
    host, ef = hyb._host, hyb.ef
    n = len(index)
    _phase("hybrid", f"lift {n}x{index.points.shape[1]} (points, zero, "
           f"{len(index.layers)} upper layers; "
           f"{n * (index.points.shape[1] + 2 * index.config.m) * 4 / 1e9:.2f}"
           f" GB) to the host engine: {lift_s:.2f} s [{HOST}]")

    def host_all():
        return host.search_batch(q_np[:HOST_BATCH], ef=ef, k=K, n_threads=0)

    host_all()
    t0 = time.perf_counter()
    hd, hi = host_all()
    host_s = time.perf_counter() - t0
    recs = _recall_blocks(hi[:nq], gt)
    _phase("hybrid", f"host engine, all {os.cpu_count()} cores, batch "
           f"{HOST_BATCH} ef={ef}: {HOST_BATCH / host_s:.1f} qps, recall@10 "
           f"blocks {[round(r, 4) for r in recs]} [{HOST}]")
    _check_recall(recs, "hybrid host")

    host_p50 = _p50_ms(torch, lambda i: host.search_batch(
        q_np[i:i + 1], ef=ef, k=K, n_threads=1), P50_QUERIES)

    def device_one(i):
        d, _ = scan.search_batch(q_np[i:i + 1], k=K, ef=ef)
        return d

    device_p50 = _p50_ms(torch, device_one, P50_QUERIES)
    threshold = launches.run("hybrid calibrate", lambda: hyb.calibrate(
        q_np[:N_QUERIES], k=K, iters=4))
    hybrid_p50 = _p50_ms(torch, lambda i: hyb.search_batch(q_np[i:i + 1],
                                                           k=K), P50_QUERIES)
    _phase("hybrid", f"single-query p50 over {P50_QUERIES} queries: host "
           f"(1 thread) {host_p50:.4f} ms [{HOST}]; device (B=1, ScanIndex "
           f"search_batch) {device_p50:.4f} ms [{CARD}]; calibrate("
           f"{N_QUERIES} queries, iters=4) -> threshold {threshold}; hybrid "
           f"{hybrid_p50:.4f} ms ({'host' if threshold > 1 else 'device'} "
           "route)")

    # routing: B=1 to the host engine, a filter to the device, and with
    # threshold 1 everything to the device
    hyb.threshold = 2
    d, i = hyb.search_batch(q_np[:1], k=K)
    wd, wi = host.search_batch(q_np[:1], ef=max(ef, K), k=K, n_threads=1)
    if not (isinstance(i, np.ndarray) and np.array_equal(i, wi)
            and np.array_equal(d, wd)):
        raise AssertionError("hybrid: a B=1 result differs from the host "
                             "engine's")
    mask = torch.zeros(n, dtype=torch.bool, device=index.device)
    mask[::2] = True
    d, i = hyb.search_batch(q_np[:1], k=K, filter_mask=mask)
    if not (isinstance(i, torch.Tensor) and i.device == index.device
            and bool((i % 2 == 0).all())):
        raise AssertionError("hybrid: a filtered B=1 call did not route to "
                             "the device")
    hyb.threshold = 1
    d, i = hyb.search_batch(q_np, k=K)
    wd, wi = scan.search_batch(q_np, k=K, ef=ef)
    if not (torch.equal(i, wi) and torch.equal(d, wd)):
        raise AssertionError("hybrid: a B=8192 result differs from the "
                             "ScanIndex's")
    hyb.threshold = threshold
    _phase("hybrid", "routing: B=1 equals the host engine's result bit for "
           "bit (threshold 2); a filtered B=1 call ran on the device; "
           f"B={N_QUERIES} equals ScanIndex.search_batch bit for bit "
           f"(threshold 1); threshold restored to {threshold}")
    del hyb, scan, host
    torch.cuda.empty_cache()


def phase_native(torch, idt, launches, pts, queries, fname):
    """Hnsw.build(backend="native") of NATIVE_N points on all host cores,
    the card's wave build of the same points beside it, the native graph
    served on the card (search_batch, and PackedHnsw's K4) and dumped to
    ``fname`` for the CLI phase."""
    sub = pts[:NATIVE_N]
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50)
    (index, _), native_s, native_peak = _timed(torch, lambda: launches.run(
        "native build", lambda: idt.Hnsw.build(sub, cfg, backend="native")))
    launches.need("native build", [], absent=list(KERNELS))
    (_, _), wave_s, peak = _build_path(
        torch, launches, "native wave",
        lambda progress: idt.Hnsw.build(sub, cfg, progress=progress))
    launches.need("native wave", ["fused_scan_bucket_int_packed"])
    _phase("native", f"Hnsw.build(backend='native') {NATIVE_N}x{DIM} m=32 "
           f"on {os.cpu_count()} cores: {native_s:.2f} s "
           f"({NATIVE_N / native_s:.1f} pts/s) [{HOST}]; the card's wave "
           f"build of the same points: {wave_s:.2f} s "
           f"({NATIVE_N / wave_s:.1f} pts/s, peak {peak:.2f} GiB) [{CARD}]")
    _report_build(torch, idt, launches, "native", index, queries, NATIVE_N,
                  native_s, native_peak)
    _packed_path(torch, idt, launches, "native packed", index, queries,
                 plain_route=False)
    index.dump(fname)
    del index
    torch.cuda.empty_cache()


def phase_streaming(torch, idt, launches, base_file, pts, queries):
    """StreamingHnsw.load of the add phase's base with serving="scan",
    four chunks added with a compaction every STREAM_REPACK pending rows;
    after each add a bucket_pack batch (K1) gated against the truth over
    the rows visible then, and read-your-writes.  A packed serving form of
    the same graph, compiled before the last chunk, then searches with
    that chunk pending (plain-op route)."""
    t_wall = time.perf_counter()
    stream, load_s, _ = _timed(torch, lambda: idt.StreamingHnsw.load(
        base_file, serving="scan", repack_every=STREAM_REPACK))
    compactions = []
    compact = stream.compact

    def timed_compact():
        t0 = time.perf_counter()
        compact()
        torch.cuda.synchronize()
        compactions.append(time.perf_counter() - t0)

    stream.compact = timed_compact
    _phase("streaming", f"StreamingHnsw.load({len(stream)} points, "
           f"serving='scan', repack_every={STREAM_REPACK}): {load_s:.2f} s "
           f"[{CARD}]")
    step = (N_POINTS - ADD_BASE) // ADD_CALLS
    nq = N_BLOCKS * BLOCK
    packed = None

    def ryw(s, rows, pids, what, **kw):
        _, p = s.search_batch(rows[:RYW_ROWS], **kw)
        if not np.array_equal(p[:, 0].cpu().numpy(), pids[:RYW_ROWS]):
            raise AssertionError(f"{what}: a just-added point was not found "
                                 "at rank 0")

    for c in range(ADD_CALLS):
        if c == ADD_CALLS - 1:
            packed = idt.StreamingHnsw(stream.graph, serving="packed")
        rows = pts[ADD_BASE + c * step:ADD_BASE + (c + 1) * step]
        n_compact = len(compactions)
        pids, add_s, _ = _timed(torch, lambda: stream.add(rows))
        # the first batch after an add: after a compaction it also builds
        # the scan form's kernel operands, which ScanIndex makes lazily
        _, first_s, _ = _timed(torch, lambda: stream.search_batch(
            queries, **SCAN_KW))
        path = f"streaming add {c + 1}"
        gt = idt.BruteForce(stream.graph.points).search_batch(
            queries[:nq], K)[1].cpu()
        _scan(torch, launches, path, stream, queries, gt, SCAN_KW, tag=CARD)
        launches.need(path, ["fused_scan_bucket_int_packed"])
        ryw(stream, rows, pids, path, **SCAN_KW)
        _phase("streaming", f"add {c + 1}: {step} points in {add_s:.2f} s"
               + (f" (compaction {compactions[-1] * 1e3:.2f} ms)"
                  if len(compactions) > n_compact else "")
               + f"; first batch after it {first_s * 1e3:.2f} ms; "
               f"{len(stream)} points, {stream.n_pending} pending; "
               f"read-your-writes: the chunk's first {RYW_ROWS} rows found at "
               f"rank 0 [{CARD}]")
    if len(compactions) != ADD_CALLS * step // STREAM_REPACK:
        raise AssertionError(f"streaming: {len(compactions)} compactions")

    gt = idt.BruteForce(packed.graph.points).search_batch(
        queries[:nq], K)[1].cpu()

    def serve_packed():
        out = [packed.search_batch(queries[b * BLOCK:(b + 1) * BLOCK], k=K)
               for b in range(N_BLOCKS)]
        return torch.cat([p for _, p in out])

    p = launches.run("streaming packed", serve_packed)
    launches.need("streaming packed", [], absent=["walk_search"])
    recs = _recall_blocks(p.cpu(), gt)
    t = _wall_s(torch, lambda: packed.search_batch(queries[:BLOCK], k=K), 3)
    ryw(packed, rows, pids, "streaming packed", k=K)
    _phase("streaming", f"serving='packed' (compiled before add "
           f"{ADD_CALLS}, {packed.n_pending} rows pending), search_batch "
           f"batch {BLOCK}: {BLOCK / t:.1f} qps, recall@10 blocks "
           f"{[round(r, 4) for r in recs]}; read-your-writes holds; "
           f"compactions {[round(x * 1e3, 2) for x in compactions]} ms; wall "
           f"{time.perf_counter() - t_wall:.1f} s [{CARD}]")
    _check_recall(recs, "streaming packed")
    del stream, packed
    torch.cuda.empty_cache()


def phase_cli(idt_root, tmp, fname, pts):
    """``python -m instant_distance_tpu_torch`` in subprocesses: info,
    validate, convert (npz -> bincode -> info) and selftest on the native
    phase's dump, then build and search on a small .npy.  The commands
    that need no other's output run at once, in two rounds."""
    py = [sys.executable, "-m", "instant_distance_tpu_torch"]
    env = dict(os.environ, PYTHONPATH=idt_root)
    secs, outs = {}, {}

    def run_all(jobs):
        procs = {}
        try:
            for name, argv in jobs.items():
                procs[name] = (subprocess.Popen(
                    [*py, *argv], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, cwd=idt_root,
                    env=env), time.perf_counter())
            for name, (proc, t0) in procs.items():
                out, err = proc.communicate(timeout=300)
                secs[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise AssertionError(
                        f"cli {name}: exit {proc.returncode}\n"
                        f"{out[-2000:]}\n{err[-4000:]}")
                outs[name] = out
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    binf = os.path.join(tmp, "native.bin")
    vecs, qf = os.path.join(tmp, "vecs.npy"), os.path.join(tmp, "q.npy")
    np.save(vecs, pts[:4096].cpu().numpy())
    np.save(qf, pts[:3].cpu().numpy())
    small = os.path.join(tmp, "small.npz")
    run_all({"info": ["info", fname], "validate": ["validate", fname],
             "convert": ["convert", fname, binf],
             "selftest": ["selftest", fname],
             "build": ["build", vecs, small, "--seed", "3"]})
    run_all({"info bincode": ["info", binf, "--dims", str(DIM)],
             "search": ["search", small, qf, "--k", "3"]})
    info = json.loads(outs["info"])
    if not json.loads(outs["validate"])["ok"]:
        raise AssertionError(f"cli validate: {outs['validate']}")
    if json.loads(outs["info bincode"])["points"] != info["points"]:
        raise AssertionError(f"cli: the bincode copy differs: "
                             f"{outs['info bincode']}")
    selftest = json.loads(outs["selftest"])
    if selftest["recall_at_10"] < RECALL_FLOOR:
        raise AssertionError(f"cli selftest: {selftest}")
    built = json.loads(outs["build"])
    rows = [json.loads(line) for line in outs["search"].strip().splitlines()]
    if len(rows) != 3 or any(r["distances"][0] > 1e-3 for r in rows):
        raise AssertionError(f"cli search: {outs['search']}")
    _phase("cli", f"info {info['points']}x{info['dims']} layers "
           f"{info['layers']}; validate ok; convert to bincode and info; "
           f"selftest {selftest}; build {built['points']} points in "
           f"{built['build_s']} s; search 3 rows; every exit code 0; seconds "
           f"a subprocess {({k: round(v, 1) for k, v in secs.items()})} "
           f"[{CARD}; {HOST}]")


# ---------------------------------------------------------------------------
# the parallel wrappers: ShardedHnsw, its checkpoint, ShardedScanIndex, the
# Replicated* forms and a one-rank NCCL mesh (SHARDS shards on the card)
# ---------------------------------------------------------------------------

def _shard_mesh(dev):
    from instant_distance_tpu_torch.parallel.mesh import default_mesh

    return default_mesh(devices=[dev] * SHARDS)


def _same_sharded(torch, a, b) -> bool:
    """Two ShardedHnsw hold the same shards bit for bit."""
    pairs = [*zip(a.zero, b.zero), *zip(a.gids, b.gids),
             *zip(a.points, b.points)]
    pairs += [p for la, lb in zip(a.layers, b.layers) for p in zip(la, lb)]
    return (len(a.layers) == len(b.layers)
            and all(torch.equal(x, y) for x, y in pairs))


def _serve_batch(torch, launches, path, index, queries, gt, kw):
    """One sharded or replicated search at the whole batch: checked,
    recall blocks, timed.  Returns (result, recall blocks, seconds)."""
    nq = N_BLOCKS * BLOCK

    def run():
        d, i = index.search_batch(queries, **kw)
        _check_results(torch, d, i, queries.shape[0], path)
        recs = _recall_blocks(i[:nq].cpu(), gt)
        t = _wall_s(torch, lambda: index.search_batch(queries, **kw), 3)
        return (d, i), recs, t

    out, recs, t = launches.run(path, run)
    _phase(path, f"{type(index).__name__}.search_batch({kw}) batch "
           f"{queries.shape[0]}: {queries.shape[0] / t:.1f} qps "
           f"({t * 1e3:.2f} ms/batch), recall@10 blocks "
           f"{[round(r, 4) for r in recs]}, launches "
           f"{ {k: v for k, v in launches.paths[path].items() if v} } "
           f"[{CARD}]")
    _check_recall(recs, path)
    return out, recs, t


def phase_sharded(torch, idt, launches, pts, queries, gt, dev):
    """ShardedHnsw.build of the 1M x 128 points on SHARDS shards of the
    card (K1 every wave of every shard), search_batch at ef 50 on the whole
    batch, a filter and a delete, dump and load, then the packed form."""
    mesh = _shard_mesh(dev)
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50)
    t_wall = time.perf_counter()
    index, build_s, peak = _build_path(
        torch, launches, "sharded",
        lambda progress: idt.ShardedHnsw.build(pts, cfg, mesh=mesh,
                                               progress=progress))
    launches.need("sharded", ["fused_scan_bucket_int_packed"])
    _phase("sharded", f"ShardedHnsw.build {N_POINTS}x{DIM} m=32 wave 4096 "
           f"on {SHARDS} shards of one card: {build_s:.1f} s "
           f"({N_POINTS / build_s:.1f} pts/s), peak memory {peak:.2f} GiB, "
           f"reverse drops {index.reverse_drops}; launches "
           f"{ {k: v for k, v in launches.paths['sharded'].items() if v} } "
           f"[{CARD}]")
    kw = dict(k=K, ef=50)
    (d, g), _, _ = _serve_batch(torch, launches, "sharded search", index,
                                queries, gt, kw)
    # a filter: even global ids only
    even = torch.arange(N_POINTS, device=dev) % 2 == 0
    _, fg = index.search_batch(queries[:BLOCK], filter_mask=even, **kw)
    if not (bool((fg >= 0).all()) and bool((fg % 2 == 0).all())):
        raise AssertionError("sharded: the filter let an odd id through")
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "sharded.npz")
        t0 = time.perf_counter()
        index.dump(fname)
        dump_s = time.perf_counter() - t0
        size_gb = os.path.getsize(fname) / 1e9
        t0 = time.perf_counter()
        loaded = idt.ShardedHnsw.load(fname, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    ld, lg = loaded.search_batch(queries, **kw)
    if not (_same_sharded(torch, loaded, index) and torch.equal(ld, d)
            and torch.equal(lg, g)):
        raise AssertionError("sharded: the loaded index differs")
    # a delete: every first hit of the first block, on the loaded copy
    victims = torch.unique(g[:BLOCK, 0]).cpu().numpy()
    loaded.delete(victims)
    _, dg = loaded.search_batch(queries[:BLOCK], **kw)
    if np.isin(dg.cpu().numpy(), victims).any():
        raise AssertionError("sharded: a deleted id came back")
    _phase("sharded", f"filter (even ids) honoured; dump {size_gb:.2f} GB "
           f"in {dump_s:.2f} s, load in {load_s:.2f} s, results equal bit "
           f"for bit; delete of {len(victims)} ids honoured")
    del loaded
    t0 = time.perf_counter()
    packed = index.pack()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    _phase("sharded packed", f"pack(pack_links=32): {pack_s:.2f} s")
    _serve_batch(torch, launches, "sharded packed", packed, queries, gt, kw)
    launches.need("sharded packed", [], absent=list(KERNELS))
    _phase("sharded", f"wall {time.perf_counter() - t_wall:.1f} s")
    del packed, index
    torch.cuda.empty_cache()


def phase_sharded_checkpoint(torch, idt, launches, pts, queries, dev):
    """SHARD_CKPT_N points on SHARDS shards, the last one padded: build A,
    build B with a checkpoint every CKPT_EVERY waves stopped halfway,
    build C resumed from B's file equal to A bit for bit; the recall gate
    over all queries and over the true neighbours in the last shard."""
    from instant_distance_tpu_torch.parallel import sharded

    mesh = _shard_mesh(dev)
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50)
    sub = pts[:SHARD_CKPT_N]
    t_wall = time.perf_counter()
    a, build_s, peak = _build_path(
        torch, launches, "sharded checkpoint A",
        lambda progress: idt.ShardedHnsw.build(sub, cfg, mesh=mesh,
                                               progress=progress))
    launches.need("sharded checkpoint A", ["fused_scan_bucket_int_packed"])

    def stop(done, total, phase):
        if done >= total // 2:
            raise _Stop(done)

    saves, save = [], sharded._save_sharded_ckpt

    def timed_save(*args):
        t0 = time.perf_counter()
        save(*args)
        saves.append(time.perf_counter() - t0)

    sharded._save_sharded_ckpt = timed_save
    try:
        with tempfile.TemporaryDirectory() as tmp:
            fname = os.path.join(tmp, "sharded.ckpt.npz")
            try:
                launches.run("sharded checkpoint B", lambda: idt.ShardedHnsw
                             .build(sub, cfg, mesh=mesh, progress=stop,
                                    checkpoint=fname,
                                    checkpoint_every=CKPT_EVERY))
                raise AssertionError("sharded checkpoint: B was not stopped")
            except _Stop:
                pass
            b_saves, size_mb = len(saves), os.path.getsize(fname) / 1e6
            c, c_s, _ = _build_path(
                torch, launches, "sharded checkpoint C",
                lambda progress: idt.ShardedHnsw.build(
                    sub, cfg, mesh=mesh, progress=progress, checkpoint=fname,
                    checkpoint_every=CKPT_EVERY))
            left = os.path.exists(fname)
    finally:
        sharded._save_sharded_ckpt = save
    launches.need("sharded checkpoint C", ["fused_scan_bucket_int_packed"])
    if left:
        raise AssertionError("sharded checkpoint: the file outlived the build")
    if not _same_sharded(torch, a, c):
        raise AssertionError("sharded checkpoint: resumed C differs from A")
    refs, pad_pids = _pad_refs(torch, c, "sharded checkpoint C")
    nq = N_BLOCKS * BLOCK
    gt = idt.BruteForce(sub).search_batch(queries[:nq], K)[1].cpu().numpy()
    found = launches.run("sharded checkpoint search", lambda: c.search_batch(
        queries[:nq], k=K, ef=50)[1].cpu().numpy())
    recs = _recall_blocks(found, gt)
    pads = len(pad_pids)
    last = _shard_recalls(c, found, gt)[-1]
    _phase("sharded checkpoint", f"{SHARD_CKPT_N} points, {pads} pad rows "
           f"in the last shard at pids {pad_pids}, {refs} pad references "
           f"in C: A {build_s:.1f} s "
           f"({SHARD_CKPT_N / build_s:.1f} pts/s, peak {peak:.2f} GiB); B "
           f"stopped at half; file {size_mb:.1f} MB; saves every "
           f"{CKPT_EVERY} waves, seconds each: B "
           f"{[round(x, 3) for x in saves[:b_saves]]}, C "
           f"{[round(x, 3) for x in saves[b_saves:]]}; C resumed in "
           f"{c_s:.1f} s equal to A bit for bit, file removed; recall@10 "
           f"blocks {[round(r, 4) for r in recs]}, over the last shard's "
           f"true neighbours {last:.4f}; wall "
           f"{time.perf_counter() - t_wall:.1f} s")
    _check_recall(recs, "sharded checkpoint")
    _check_recall([last], "sharded checkpoint last shard")
    del a, c
    torch.cuda.empty_cache()

    # D: the same points under dot (K2 with is_dot every wave), where a
    # pad row in the graph would be every query's nearest point
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50,
                     metric="dot")
    d, d_s, d_peak = _build_path(
        torch, launches, "sharded checkpoint D",
        lambda progress: idt.ShardedHnsw.build(sub, cfg, mesh=mesh,
                                               progress=progress))
    launches.need("sharded checkpoint D", ["fused_scan_bucket"],
                  absent=["fused_scan_bucket_int_packed"])
    refs, pad_pids = _pad_refs(torch, d, "sharded checkpoint D")
    gt = idt.BruteForce(sub, metric="dot").search_batch(
        queries[:nq], K)[1].cpu().numpy()
    found = launches.run("sharded checkpoint D search", lambda: d.search_batch(
        queries[:nq], k=K, ef=50)[1].cpu().numpy())
    recs = _recall_blocks(found, gt)
    per = _shard_recalls(d, found, gt)
    counts = launches.paths["sharded checkpoint D"]
    _phase("sharded checkpoint D", f"metric dot, {SHARD_CKPT_N} points: "
           f"build {d_s:.1f} s ({SHARD_CKPT_N / d_s:.1f} pts/s, peak "
           f"{d_peak:.2f} GiB); pad pids {pad_pids}, {refs} pad references; "
           f"recall@10 blocks {[round(r, 4) for r in recs]}, over each "
           f"shard's true neighbours {[round(r, 4) for r in per]}; launches "
           f"{ {k: v for k, v in counts.items() if v} } [{CARD}]")
    if per[-1] < np.mean(per[:-1]) - 0.02:
        raise AssertionError(f"sharded checkpoint D: last shard recall "
                             f"{per[-1]} below the others' {per[:-1]}")
    del d
    torch.cuda.empty_cache()


def _pad_refs(torch, index, what: str):
    """The links to or from pad rows over every shard and layer of a
    ShardedHnsw (rows that hold one), and the last shard's pad pids; it
    raises unless there are none and the pad rows are the last pids."""
    refs = 0
    for j, gids in enumerate(index.gids):
        pad = gids < 0
        for rows in [index.zero[j]] + [level[j] for level in index.layers]:
            p = pad[:rows.shape[0]]
            to_pad = (rows >= 0) & pad[rows.clamp(min=0).long()]
            refs += int(to_pad[~p].any(1).sum())
            refs += int((rows[p] >= 0).any(1).sum())
    pad_pids = torch.nonzero(index.gids[-1] < 0).flatten().tolist()
    n_s = index.gids[-1].shape[0]
    if refs or pad_pids != list(range(n_s - len(pad_pids), n_s)):
        raise AssertionError(f"{what}: {refs} pad references, pad pids "
                             f"{pad_pids}")
    return refs, pad_pids


def _shard_recalls(index, found, gt) -> list:
    """recall@10 over the true neighbours that lie in each shard."""
    out = []
    for gids in index.gids:
        inside = np.isin(gt, gids.cpu().numpy())
        out.append(float(sum(np.isin(gt[r][inside[r]], found[r]).sum()
                             for r in range(len(gt))) / inside.sum()))
    return out


def phase_sharded_scan(torch, idt, launches, pts, queries, gt, dev):
    """ShardedScanIndex of the 1M x 128 points on SHARDS shards: fused=True
    (K2 on every shard) on the whole batch, the streamed scan at a batch
    of BLOCK, dump and load."""
    mesh = _shard_mesh(dev)
    t0 = time.perf_counter()
    scan = idt.ShardedScanIndex(pts, mesh=mesh)
    torch.cuda.synchronize()
    _phase("sharded scan", f"ShardedScanIndex {N_POINTS}x{DIM} on {SHARDS} "
           f"shards: {time.perf_counter() - t0:.2f} s")
    kw = dict(k=K, ef=32, fused=True)
    (d, i), _, _ = _serve_batch(torch, launches, "sharded scan", scan,
                                queries, gt, kw)
    launches.need("sharded scan", ["fused_scan_bucket"],
                  absent=["fused_scan_bucket_int_packed"])
    nq = N_BLOCKS * BLOCK

    def streamed():
        found = torch.cat([scan.search_batch(queries[b:b + BLOCK], k=K)[1]
                           for b in range(0, nq, BLOCK)])
        t = _wall_s(torch, lambda: scan.search_batch(queries[:BLOCK], k=K),
                    3)
        return _recall_blocks(found.cpu(), gt), t

    recs, t = launches.run("sharded scan streamed", streamed)
    launches.need("sharded scan streamed", [], absent=list(KERNELS))
    _phase("sharded scan streamed", f"search_batch(k={K}) batch {BLOCK}: "
           f"{BLOCK / t:.1f} qps ({t * 1e3:.2f} ms/batch), recall@10 blocks "
           f"{[round(r, 4) for r in recs]} [{CARD}]")
    _check_recall(recs, "sharded scan streamed")
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "scan.npz")
        scan.dump(fname)
        loaded = idt.ShardedScanIndex.load(fname, mesh=mesh)
    ld, li = loaded.search_batch(queries, **kw)
    if not (torch.equal(ld, d) and torch.equal(li, i)):
        raise AssertionError("sharded scan: the loaded index differs")
    _phase("sharded scan", "dump, load: fused results equal bit for bit")
    del scan, loaded
    torch.cuda.empty_cache()


def phase_replicated(torch, idt, launches, index, packed, pts, queries, gt,
                     dev):
    """The replicated forms on SHARDS slices of the card: ReplicatedHnsw
    over the hnsw phase's (loaded) index against its own search_batch at
    the whole batch and two queries fewer, ReplicatedPackedHnsw against
    PackedHnsw.search_batch, ReplicatedScanIndex(fused=True) (K2), and a
    ReplicatedHnsw on default_mesh() (every visible card)."""
    from instant_distance_tpu_torch.parallel.mesh import default_mesh

    mesh = _shard_mesh(dev)
    kw = dict(k=K, ef=50)
    rep = idt.ReplicatedHnsw(index, mesh)
    for b in (queries.shape[0], queries.shape[0] - 2):
        got = launches.run("replicated", lambda: rep.search_batch(
            queries[:b], **kw))
        want = index.search_batch(queries[:b], **kw)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"replicated: ReplicatedHnsw differs from "
                                 f"the index at B={b}")
    t_rep = _wall_s(torch, lambda: rep.search_batch(queries, **kw), 3)
    t_one = _wall_s(torch, lambda: index.search_batch(queries, **kw), 3)
    everyone = default_mesh()
    got = idt.ReplicatedHnsw(index, everyone).search_batch(queries, **kw)
    want = index.search_batch(queries, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("replicated: default_mesh() differs")
    _phase("replicated", f"ReplicatedHnsw on {SHARDS} slices equal to "
           f"search_batch bit for bit at B={queries.shape[0]} and "
           f"B={queries.shape[0] - 2}; {queries.shape[0] / t_rep:.1f} qps "
           f"against {queries.shape[0] / t_one:.1f} for the index alone; "
           f"default_mesh() = {len(everyone.devices)} card(s), equal [{CARD}]")
    rep = idt.ReplicatedPackedHnsw(packed, mesh)
    got = launches.run("replicated packed",
                       lambda: rep.search_batch(queries, **kw))
    launches.need("replicated packed", [], absent=list(KERNELS))
    want = packed.search_batch(queries, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("replicated: ReplicatedPackedHnsw differs from "
                             "PackedHnsw.search_batch")
    _phase("replicated", "ReplicatedPackedHnsw equal to "
           "PackedHnsw.search_batch bit for bit")
    scan = idt.ScanIndex(pts)
    _serve_batch(torch, launches, "replicated scan",
                 idt.ReplicatedScanIndex(scan, mesh), queries, gt,
                 dict(k=K, ef=32, fused=True))
    launches.need("replicated scan", ["fused_scan_bucket"],
                  absent=["fused_scan_bucket_int_packed"])
    del scan, rep
    torch.cuda.empty_cache()


def phase_distributed(torch, idt, launches, pts, queries, dev):
    """A one-rank NCCL group on the card through distributed_mesh: a
    ShardedHnsw of DIST_N points there (its merge through all_gather)
    equals the same build on default_mesh(devices=[dev]) bit for bit."""
    import socket

    import torch.distributed as dist
    from instant_distance_tpu_torch.parallel.mesh import (default_mesh,
                                                          distributed_mesh)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50)
    sub = pts[:DIST_N]
    kw = dict(k=K, ef=50)
    t0 = time.perf_counter()
    mesh = distributed_mesh(f"tcp://127.0.0.1:{port}", 1, 0, devices=[dev])
    try:
        backend = dist.get_backend()
        join_s = time.perf_counter() - t0

        def run():
            index = idt.ShardedHnsw.build(sub, cfg, mesh=mesh)
            return index, index.search_batch(queries[:BLOCK], **kw)

        (a, (da, ga)), a_s, _ = _timed(torch, lambda: launches.run(
            "distributed", run))
        launches.need("distributed", ["fused_scan_bucket_int_packed"])
    finally:
        dist.destroy_process_group()
    b = idt.ShardedHnsw.build(sub, cfg, mesh=default_mesh(devices=[dev]))
    db, gb = b.search_batch(queries[:BLOCK], **kw)
    if not (_same_sharded(torch, a, b) and torch.equal(da, db)
            and torch.equal(ga, gb)):
        raise AssertionError("distributed: the one-rank mesh's build or "
                             "search differs from default_mesh's")
    _phase("distributed", f"{backend} group of 1 rank on "
           f"tcp://127.0.0.1:{port}, init_process_group {join_s:.2f} s (the "
           f"communicator comes up at the first collective); ShardedHnsw "
           f"{DIST_N}x{DIM} built and searched there in {a_s:.2f} s, equal "
           f"to default_mesh(devices=[{dev}]) bit for bit; group destroyed")
    del a, b
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-n", type=int, default=N_POINTS,
                    help="points in the 128-d HNSW build (default: 1M)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    global CARD, HOST
    CARD, HOST = smi, f"{_cpu_model()}, {os.cpu_count()} cores"

    import instant_distance_tpu_torch as idt
    from instant_distance_tpu_torch.ops import _build
    from instant_distance_tpu_torch.ops import scan_kernel as tsk
    from instant_distance_tpu_torch.utils.datasets import synthetic_clustered

    # -- 2. kernel build -------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    _phase("build", f"{time.perf_counter() - t0:.2f} s "
           f"(nvcc {_build.build_seconds:.2f} s); ptxas: "
           + (" | ".join(_ptxas_summary(_build.build_log))
              or "none (the libraries were built before)"))
    _phase("build", "sass: " + " | ".join(_sass_check(_build)))
    _phase("build", "Hopper tile (K1/K6, K2/K3; one block an SM): "
           + _tile_plans(_build))
    from instant_distance_tpu_torch.ops import walk_kernel as wk

    _phase("build", f"K4 ({wk.STAGE_BYTES} B of staged codes at most): "
           + "; ".join(
               f"{what} shared memory %d B a block, %d blocks an SM"
               % wk.block_shape(d, WALK_K, PACKED_KW["ef"],
                                PACKED_KW["expand"])
               for what, d in (("D=128 K=64", DIM), ("D=300 K=64", DIM300))))

    # -- 3. kernels vs plain ---------------------------------------------
    records = phase_kernels(torch, tsk, dev)
    records["walk_search"] = phase_walk(torch, dev)
    launches = Launches(tsk)
    nq = N_BLOCKS * BLOCK

    # -- the oracle, with the examples running beside it --------------------
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        started = start_examples(root, tmp)
        try:
            phase_oracle(torch, idt, launches, dev)
        except BaseException:
            stop_examples(started)
            raise
        phase_examples(started)

    # -- 4. ScanIndex, bucket_pack, 1M x 128; the K6 attribution path ----
    t0 = time.perf_counter()
    data = synthetic_clustered(N_POINTS + N_QUERIES, DIM, n_clusters=10000,
                               seed=3)
    pts = torch.from_numpy(data[:N_POINTS]).to(dev)
    queries = torch.from_numpy(data[N_POINTS:]).to(dev)
    del data
    _phase("data", f"{N_POINTS + N_QUERIES}x{DIM} clustered, "
           f"{time.perf_counter() - t0:.1f} s")
    gt = idt.BruteForce(pts).search_batch(queries[:nq], K)[1].cpu()
    scan = idt.ScanIndex(pts)
    one_shot = _scan(torch, launches, "scan", scan, queries, gt, SCAN_KW)
    launches.need("scan", ["fused_scan_bucket_int_packed"])
    phase_scan_groups(torch, launches, scan, queries, gt)
    del scan
    _attribution(torch, tsk, launches, pts, queries)

    # -- 5. HNSW build + search, 1M x 128 ----------------------------------
    bn = min(args.build_n, N_POINTS)
    cfg = idt.Config(seed=3, m=32, wave_size=4096, ef_search=50)
    (index, _), build_s, peak = _build_path(
        torch, launches, "hnsw",
        lambda progress: idt.Hnsw.build(pts[:bn], cfg, progress=progress))
    launches.need("hnsw", ["fused_scan_bucket_int_packed"])
    recs, t = _search_path(torch, idt, launches, "hnsw", index, queries)
    hnsw_recs = recs
    _phase("hnsw", f"build {bn}x{DIM} m=32 wave 4096: {build_s:.1f} s "
           f"({bn / build_s:.1f} pts/s), peak memory {peak:.2f} GiB, "
           f"reverse drops {index.reverse_drops}; search ef=50 batch {BLOCK}: "
           f"{BLOCK / t:.1f} qps, recall@10 blocks "
           f"{[round(r, 4) for r in recs]}")
    _check_recall(recs, "hnsw")
    phase_hybrid(torch, idt, launches, index, queries)
    phase_sharded(torch, idt, launches, pts, queries, gt, dev)

    # -- 6. the packed serving flow on that index ------------------------
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "index.npz")
        t0 = time.perf_counter()
        index.dump(fname)
        dump_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = idt.Hnsw.load(fname)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size_gb = os.path.getsize(fname) / 1e9
    if not (torch.equal(served.zero, index.zero)
            and torch.equal(served.points, index.points)):
        raise AssertionError("packed: the loaded index differs")
    _phase("packed", f"dump {size_gb:.2f} GB in {dump_s:.2f} s, Hnsw.load "
           f"in {load_s:.2f} s")
    del index
    packed, records["walk_search"] = _packed_path(
        torch, idt, launches, "packed", served, queries, plain_route=True)
    phase_replicated(torch, idt, launches, served, packed, pts, queries, gt,
                     dev)
    del packed, served
    torch.cuda.empty_cache()
    phase_sharded_scan(torch, idt, launches, pts, queries, gt, dev)

    # -- 10-12. add (and streaming), beam and checkpoint on that data ------
    with tempfile.TemporaryDirectory() as tmp:
        base_file = os.path.join(tmp, "base.npz")
        phase_add(torch, idt, launches, pts, queries, gt, one_shot, hnsw_recs,
                  base_file)
        del one_shot
        phase_streaming(torch, idt, launches, base_file, pts, queries)
    phase_beam(torch, idt, launches, pts, queries)
    phase_checkpoint(torch, idt, launches, pts, queries)
    phase_sharded_checkpoint(torch, idt, launches, pts, queries, dev)
    phase_distributed(torch, idt, launches, pts, queries, dev)

    # -- the host engine's build, served on the card; the CLI --------------
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "native.npz")
        phase_native(torch, idt, launches, pts, queries, fname)
        phase_cli(root, tmp, fname, pts)
    del pts, queries
    torch.cuda.empty_cache()

    # -- 7. ScanIndex at 300-d: bucket_pack -> K3, cosine bucket / topt ----
    t0 = time.perf_counter()
    data = synthetic_clustered(N_POINTS + N_QUERIES, DIM300,
                               n_clusters=10000, seed=5)
    pts = torch.from_numpy(data[:N_POINTS]).to(dev)
    queries = torch.from_numpy(data[N_POINTS:]).to(dev)
    del data
    _phase("data", f"{N_POINTS + N_QUERIES}x{DIM300} clustered, "
           f"{time.perf_counter() - t0:.1f} s")
    gt = idt.BruteForce(pts).search_batch(queries[:nq], K)[1].cpu()
    scan = idt.ScanIndex(pts)
    _scan(torch, launches, "scan300", scan, queries, gt, SCAN_KW)
    launches.need("scan300", ["fused_scan_bucket_int"],
                  absent=["fused_scan_bucket_int_packed"])
    del scan
    gt = idt.BruteForce(pts, "cosine").search_batch(queries[:nq], K)[1].cpu()
    scan = idt.ScanIndex(pts, metric="cosine")
    _scan(torch, launches, "scan300 cosine bucket", scan, queries, gt,
          dict(k=K, fused="bucket", ef=32))
    launches.need("scan300 cosine bucket", ["fused_scan_bucket"])
    _scan(torch, launches, "scan300 cosine topt", scan, queries, gt,
          dict(k=K, fused="topt", ef=32))
    launches.need("scan300 cosine topt", ["fused_scan_topt"])
    del scan
    torch.cuda.empty_cache()

    # -- 8. HnswMap build + search, 1M x 300 (K2 in every wave) ------------
    cfg = idt.Config(seed=5, m=32, wave_size=4096, ef_search=50)
    langs = ("en", "fr", "it")
    values = [f"{langs[i % 3]}word{i}_{langs[i % 3]}"
              for i in range(N_POINTS)]
    index, build_s, peak = _build_path(
        torch, launches, "hnsw300",
        lambda progress: idt.HnswMap.build(pts, values, cfg,
                                           progress=progress))
    launches.need("hnsw300", ["fused_scan_bucket"],
                  absent=["fused_scan_bucket_int_packed"])
    recs, t = _search_path(torch, idt, launches, "hnsw300", index, queries)
    hits = list(index.search(queries[0], idt.Search()))
    if not hits or hits[0].value != index.values[hits[0].pid]:
        raise AssertionError("hnsw300: the Search iterator gave no value")
    _phase("hnsw300", f"HnswMap.build {N_POINTS}x{DIM300} m=32 wave 4096: "
           f"{build_s:.1f} s ({N_POINTS / build_s:.1f} pts/s), peak memory "
           f"{peak:.2f} GiB, reverse drops {index.reverse_drops}; search "
           f"ef=50 batch {BLOCK}: {BLOCK / t:.1f} qps, recall@10 blocks "
           f"{[round(r, 4) for r in recs]}; search -> {len(hits)} hits, "
           f"first {hits[0].value!r} at {hits[0].distance:.4f}")
    _check_recall(recs, "hnsw300")

    # -- 9. the packed serving form of the map, D = 300 -------------------
    packed, _ = _packed_path(torch, idt, launches, "packed300", index,
                             queries, plain_route=False)
    d, p, vals = packed.search_batch_values(queries[:4], k=3)
    if vals != [[index.values[i] for i in row] for row in p.cpu().tolist()]:
        raise AssertionError("packed300: search_batch_values lost values")
    _phase("packed300", f"search_batch_values -> {vals[0]}")
    del packed, index, pts, queries
    torch.cuda.empty_cache()

    # -- 13. the sampled build at DEEP's width ------------------------------
    phase_sampled(torch, idt, launches, dev)

    # -- the ladder's GIST1M rung: K1, K3, K2 and K4 at D = 960 -------------
    phase_ladder(torch, idt, tsk, launches, dev)

    # -- 14. the paths ran through every kernel ----------------------------
    _phase("launches", "; ".join(
        f"{path}: { {k: v for k, v in c.items() if v} }"
        for path, c in launches.paths.items()))
    _phase("launches", "point-major code copies: " + "; ".join(
        f"{path}: {n}" for path, n in launches.copies.items() if n))
    _phase("wall", f"{time.perf_counter() - t_start:.1f} s, the kernels' "
           "build included")
    out = []
    for kernel, (source, replaces) in KERNELS.items():
        rec = records[kernel]
        if launches.total(kernel) < 1:
            raise AssertionError(f"no path launched {kernel}")
        out.append({
            "name": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.total(kernel),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "case": rec["case"]})
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
