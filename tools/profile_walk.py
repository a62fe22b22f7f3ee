"""Where a K4 step's time goes, on the card: cycles per phase of a step.

    python tools/profile_walk.py [--iters N]

Compiles a copy of ``csrc/walk_kernel.cu`` into ``build/kernels/`` with
``clock64()`` marks at the phase boundaries of a step (thread 0 of every
block adds each phase's cycles), runs it on ``chip_smoke.py``'s random
valid graph (65,536 nodes, K = 64, D 128 and 300, 1024 queries, ef 50,
expand 2) at each staging size of ``time_walk.SWEEP``, checks the
beams against ``walk_search_plain``, and prints, per setting, the
kernel's CUDA-event time, the steps a query takes (mean and max) and
the mean cycles a step spends in each phase: the pick, staging the ids
and scales (up to the first barrier), the first row's dedup while the
codes land (up to the second), scoring, the second row's dedup with the
compaction, and the sort and merge.  A phase's cycles are the block's
wall time, so they include waiting for issue slots that the SM's other
blocks hold.  Needs a CUDA card; the marks cost time of their own, so
take kernel times from ``chip_smoke.py`` or ``tools/time_walk.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PHASES = ("pick", "stage ids", "dedup row 0", "score", "compact", "merge")
#: (text of the kernel, text put before it): the marks, in phase order;
#: the kernel's parameters and entry points gain the profile buffer.
MARKS = (
    ("int max_iters, int stage_cap) {\n",
     None),
    ("  __syncthreads();\n\n  for (int it = 0; it < max_iters; ++it) {",
     "  long long pa[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long pt = clock64();\n"
     "#define PROF(i) if (tid == 0) { const long long t_ = clock64(); "
     "pa[i] += t_ - pt; pt = t_; }\n"),
    ("    if (tid == 0) npass = 0;\n",
     "    PROF(0);\n    if (tid == 0) ++pa[7];\n"),
    ("    // the first row's dedup while the codes land", "    PROF(1);\n"),
    ("    // 3. score:", "    PROF(2);\n"),
    ("    // 4. the second row's dedup", "    PROF(3);\n"),
    ("    // 5. sort the passing candidates", "    PROF(4);\n"),
    ("    if (npool > 0) {\n      float* tf = bd;", "    PROF(5);\n"),
    ("  for (int s = tid; s < ef; s += kThreads) {\n    bd_out[",
     "  if (tid == 0)\n"
     "    for (int i = 0; i < 8; ++i) prof[row * 8 + i] = pa[i];\n"),
)


def _profiled_source() -> str:
    path = os.path.join(HERE, "instant_distance_tpu_torch", "csrc",
                        "walk_kernel.cu")
    with open(path) as f:
        src = f.read()

    def sub(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"walk_kernel.cu changed: {old!r}")
        src = src.replace(old, new)

    for anchor, before in MARKS:
        if before is None:
            sub(anchor,
                "int max_iters, int stage_cap, long long* prof) {\n")
        else:
            sub(anchor, before + anchor)
    sub("int stage_cap, void* stream) {",
        "int stage_cap, long long* prof, void* stream) {")
    sub("expand, max_iters, stage_cap);\n",
        "expand, max_iters, stage_cap, prof);\n")
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_walk: no CUDA device", file=sys.stderr)
        return 1
    from instant_distance_tpu_torch.ops import _build
    from instant_distance_tpu_torch.ops import walk_kernel as wk

    spec = importlib.util.spec_from_file_location(
        "time_walk", os.path.join(HERE, "tools", "time_walk.py"))
    tw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tw)
    smoke = tw._smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "walk_kernel_phases.cu")
    with open(src, "w") as f:
        f.write(_profiled_source())
    out = os.path.join(_build.BUILD_DIR, "walk_kernel_phases.so")
    _build._compile({src: out})
    fn = ctypes.CDLL(out).idt_walk_search
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 2
    dev = torch.device("cuda", 0)
    ef, expand = smoke.WALK_EF, 2
    max_iters = 8 * ef + 16
    for shape, ops in tw._shapes(torch, smoke, dev, False).items():
        b, d = ops[0].shape
        k = ops[3].shape[1]
        want = wk.walk_search_plain(*ops, expand=expand, ef=ef,
                                    max_iters=max_iters)
        for stage in tw.SWEEP:
            prof = torch.zeros((b, 8), dtype=torch.int64, device=dev)
            bd, bp = torch.empty_like(want[0]), torch.empty_like(want[1])
            call = [t.data_ptr() for t in ops] + [
                bd.data_ptr(), bp.data_ptr(), b, d, k, ef, expand, max_iters,
                stage, prof.data_ptr(),
                torch.cuda.current_stream().cuda_stream]
            if fn(*call):
                raise RuntimeError("walk_search failed to launch")
            torch.cuda.synchronize()
            if not (torch.equal(bd, want[0]) and torch.equal(bp, want[1])):
                raise AssertionError(f"{shape}: differs from plain")
            steps = prof[:, 7].double()
            cycles = prof[:, :6].double().sum(0) / steps.sum()
            ms = smoke._cuda_ms(torch, lambda: fn(*call), args.iters)
            print(f"{shape} stage={stage}: {ms:.4f} ms with "
                  f"the marks; steps a query {steps.mean():.1f} (max "
                  f"{int(steps.max())}); cycles a step: " + ", ".join(
                      f"{n} {c:.0f}"
                      for n, c in zip(PHASES, cycles.tolist())),
                  flush=True)
        del ops, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
