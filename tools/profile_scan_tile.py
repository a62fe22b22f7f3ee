"""Where the Hopper scan tile's time goes, on the card: cycles per phase of
a slab, for K1 (with its probe K6) and K2 at the smoke's main shapes.

    python tools/profile_scan_tile.py [--iters N]

Copies ``csrc/`` into ``build/profile_scan_tile/`` with ``clock64()``
marks in ``csrc/wgmma_tile.cuh``'s consumer and producer loops, builds
``scan_kernel.cu`` and ``bucket_kernel.cu`` there with the package's
nvcc flags, runs them on ``chip_smoke.py``'s random operands and prints,
per shape, the CUDA-event time and, per consumer warp and slab, the mean
cycles spent issuing the slab's products (with the waits for its code
chunks, given apart), draining them (``wgmma.wait_group 0``) and in the
epilogue (the caller's reduction and the stage's release), and per
block the producer's cycles, its waits for free stages among them.  A
phase's cycles are the warp's wall time, so they include waiting for
issue slots that the SM's other warps hold.  Needs a CUDA card; the
marks cost time of their own, so take kernel times from
``chip_smoke.py`` or ``tools/time_torch_kernels.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

OUT = os.path.join(HERE, "build", "profile_scan_tile")
#: (text of csrc/wgmma_tile.cuh, text put in its place): the marks.
#: Counters: 0 issue (with the chunk waits), 1 drain, 2 epilogue, 3 warp
#: slabs, 4 chunk waits, 5 producer's stage waits, 6 producer cycles,
#: 7 producers.
MARKS = (
    ("namespace idt {\nnamespace wg {\n",
     "namespace idt {\nnamespace wg {\n"
     "__device__ unsigned long long prof[8];\n"),
    ("    for (int t = 0; t < lsub; ++t) {\n      const int p = p0 + t * ct;\n",
     "    unsigned long long ce = 0;\n    const long long tp = clock64();\n"
     "    for (int t = 0; t < lsub; ++t) {\n      const int p = p0 + t * ct;\n"),
    ("        bar_wait(empty + s, ph ^ 1);\n",
     "        const long long e0 = clock64();\n"
     "        bar_wait(empty + s, ph ^ 1);\n        ce += clock64() - e0;\n"),
    ("    for (int t = 0; t < lsub; ++t) {\n      int prev = 0;\n",
     "    unsigned long long c[5] = {0, 0, 0, 0, 0};\n"
     "    for (int t = 0; t < lsub; ++t) {\n      int prev = 0;\n"
     "      const long long t0 = clock64();\n"),
    ("        bar_wait(full + s, ph);\n",
     "        const long long w0 = clock64();\n"
     "        bar_wait(full + s, ph);\n        c[4] += clock64() - w0;\n"),
    ("      wgmma_wait<0>();\n      fence_acc(acc);\n",
     "      const long long t1 = clock64();\n"
     "      wgmma_wait<0>();\n      fence_acc(acc);\n"
     "      const long long t2 = clock64();\n"),
    ("      if (lead) bar_arrive(empty + prev);\n    }\n  }\n",
     "      if (lead) bar_arrive(empty + prev);\n"
     "      c[0] += t1 - t0; c[1] += t2 - t1; c[2] += clock64() - t2;"
     " c[3] += 1;\n    }\n"
     "    if (lead)\n      for (int i = 0; i < 5; ++i) atomicAdd(&prof[i], c[i]);\n"
     "  }\n"),
)
#: The producer's totals, added where produce() returns.
PRODUCER_END = (
    "        if (++s == plan.stages) {\n          s = 0;\n          ph ^= 1;\n"
    "        }\n      }\n    }\n  }\n",
    "        if (++s == plan.stages) {\n          s = 0;\n          ph ^= 1;\n"
    "        }\n      }\n    }\n    atomicAdd(&prof[5], ce);\n"
    "    atomicAdd(&prof[6], clock64() - tp);\n    atomicAdd(&prof[7], 1ull);\n"
    "  }\n")
READ = '''
extern "C" int idt_prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, idt::wg::prof, sizeof(idt::wg::prof));
  const unsigned long long zero[8] = {};
  cudaMemcpyToSymbol(idt::wg::prof, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
'''


def _instrument() -> None:
    """Copy csrc/ into OUT with the marks in wgmma_tile.cuh."""
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "instant_distance_tpu_torch", "csrc"),
                    OUT)
    path = os.path.join(OUT, "wgmma_tile.cuh")
    with open(path) as f:
        s = f.read()
    for old, new in MARKS + (PRODUCER_END,):
        if s.count(old) != 1:
            raise RuntimeError(f"mark not found once: {old[:60]!r}")
        s = s.replace(old, new)
    with open(path, "w") as f:
        f.write(s + READ)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from instant_distance_tpu_torch.ops import _build
    from instant_distance_tpu_torch.ops import scan_kernel as tsk

    if not torch.cuda.is_available():
        print("profile_scan_tile: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _instrument()
    libs, procs = {}, []
    for stem in ("scan_kernel", "bucket_kernel"):
        procs.append((stem, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             os.path.join(OUT, f"{stem}.cu"), "-o",
             os.path.join(OUT, f"{stem}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for stem, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(out)
        lib = ctypes.CDLL(os.path.join(OUT, f"{stem}.so"))
        for name, (restype, argtypes) in _build._SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
        lib.idt_prof_read.argtypes = [ctypes.c_void_p]
        libs[stem] = lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda", 0)
    buf = (ctypes.c_ulonglong * 8)()

    def profile(what, lib, call):
        call()
        torch.cuda.synchronize()
        lib.idt_prof_read(buf)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            call()
        end.record()
        torch.cuda.synchronize()
        if lib.idt_prof_read(buf):
            raise RuntimeError("reading the counters failed")
        c = [v / args.iters for v in buf]
        slabs, blocks = max(c[3], 1), max(c[7], 1)
        print(f"{what}: {start.elapsed_time(end) / args.iters:.3f} ms with "
              f"the marks; cycles a consumer warp and slab: issue "
              f"{c[0] / slabs:.0f} (chunk waits {c[4] / slabs:.0f}), drain "
              f"{c[1] / slabs:.0f}, epilogue {c[2] / slabs:.0f}; producer "
              f"{c[6] / blocks:.0f} cycles a block, {c[5] / blocks:.0f} of "
              f"them waiting for free stages", flush=True)

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    for label, kernel, b, d, n, lsub, cb, opts in (
            smoke.KERNEL_CASES + smoke.LADDER_CASES):
        if label not in ("scan batch", "build wave", "replicated scan slice",
                         "ladder scan lsub 16", "ladder build wave") or \
                kernel not in ("fused_scan_bucket_int_packed",
                               "fused_scan_bucket"):
            continue
        rows, shared, _ = smoke._operands(torch, tsk, dev, kernel, b, d, n,
                                          lsub, cb, opts)
        q, pm, dpad = tsk._tile_args(rows[0], shared[-1] if kernel ==
                                     "fused_scan_bucket_int_packed" else
                                     shared[0], lsub, cb)
        od = torch.empty((b, n // lsub), dtype=torch.int32, device=dev)
        what = f"{kernel} {label} B={b} D={d} N={n} lsub={lsub}"
        if kernel == "fused_scan_bucket_int_packed":
            lib, w2 = libs["scan_kernel"], shared[0]
            for probe in tsk.PROBES:
                profile(f"{what} probe {probe}", lib, lambda p=probe:
                        lib.idt_probe_scan(q.data_ptr(), w2.data_ptr(),
                                           pm.data_ptr(), od.data_ptr(), b,
                                           dpad, n, lsub, cb,
                                           tsk.PROBES.index(p), stream()))
        else:
            lib, (qs,), (scales, norms) = (libs["bucket_kernel"], rows[1:],
                                           shared[1:])
            oi = torch.empty_like(od)
            profile(what, lib, lambda: lib.idt_bucket_scan(
                q.data_ptr(), qs.data_ptr(), pm.data_ptr(),
                scales.data_ptr(), norms.data_ptr(), od.data_ptr(),
                oi.data_ptr(), b, dpad, n, lsub, cb, int(opts["is_dot"]),
                stream()))
        del rows, shared, q, pm, od
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
