"""Time the PyTorch port's scan kernels at ``chip_smoke.py``'s call shapes,
for the package of another checkout, so that two checkouts can be
compared on one card, in turns:

    python tools/time_torch_kernels.py [--root DIR] [--iters N]

The operands come from this checkout's ``chip_smoke.py`` (seeded, the
same whatever the root), the kernels from ``DIR/instant_distance_tpu_torch``
(default: this checkout), built into ``DIR/build/kernels``.  Needs a CUDA
card.  Prints the card's name and power limit, then one JSON object:
``{"root": DIR, "ms": {"kernel case": mean CUDA-event ms}, "floor_ms":
{"kernel case": ms}}``, floor_ms being K2's CUDA-core floor: the B * N
elements of its f32 epilogue times the operations an element takes
(``K2_EPILOGUE_OPS``) at 132 SMs x 128 lanes x the card's
``clocks.max.sm``.  Run the two checkouts in turns (A, B, B, A) on one
machine, and compare only times taken there together: cards differ in
power limit and neighbours.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (kernel, case label) of chip_smoke.KERNEL_CASES and LADDER_CASES timed
#: here: every call shape of K1, K2 and K3 in PERF.md's kernel table (the
#: ladder's three at D = 960 among them), K2 on K5's operands and K5.
CASES = (("fused_scan_bucket_int_packed", "scan batch"),
         ("fused_scan_bucket_int_packed", "kgroup batch"),
         ("fused_scan_bucket_int_packed", "build wave"),
         ("fused_scan_bucket_int_packed", "sharded build wave"),
         ("fused_scan_bucket", "build wave"),
         ("fused_scan_bucket", "bucket batch"),
         ("fused_scan_bucket", "sharded dot build wave"),
         ("fused_scan_bucket", "sharded scan batch"),
         ("fused_scan_bucket", "replicated scan slice"),
         ("fused_scan_bucket", "topt batch"),
         ("fused_scan_bucket_int", "scan batch"),
         ("fused_scan_topt", "topt batch"),
         ("fused_scan_bucket_int_packed", "ladder scan lsub 16"),
         ("fused_scan_bucket_int", "ladder scan lsub 32"),
         ("fused_scan_bucket", "ladder build wave"))

#: Operations of one element of K2's epilogue (csrc/bucket_kernel.cu:
#: f32_value and min_update): int-to-float, qs * s, * dot, * 2 (L2 only),
#: the subtraction, the compare, the NaN test and the two selects (value,
#: argmin slab), by is_dot.
K2_EPILOGUE_OPS = {False: 9, True: 8}
#: SMs and lanes of an H100 SXM (NVIDIA's data sheet).
SMS, LANES = 132, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose package is timed (default: this)")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_torch_kernels: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from instant_distance_tpu_torch.ops import scan_kernel as tsk

    if not os.path.abspath(tsk.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {tsk.__file__}, not from {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    dev = torch.device("cuda", 0)
    cases = {(k, label): (b, d, n, lsub, cb, opts)
             for label, k, b, d, n, lsub, cb, opts
             in smoke.KERNEL_CASES + smoke.LADDER_CASES}
    out, floor = {}, {}
    for kernel, label in CASES:
        b, d, n, lsub, cb, opts = cases[kernel, label]
        if kernel == "fused_scan_bucket":
            floor[f"{kernel} {label}"] = (
                b * n * K2_EPILOGUE_OPS[opts["is_dot"]]
                / (SMS * LANES * mhz * 1e6) * 1e3)
        rows, shared, kw = smoke._operands(torch, tsk, dev, kernel, b, d, n,
                                           lsub, cb, opts)
        out[f"{kernel} {label}"] = smoke._cuda_ms(
            torch, lambda: smoke._call(tsk, kernel, rows, shared, kw),
            args.iters)
        del rows, shared
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "ms": out, "floor_ms": floor}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
