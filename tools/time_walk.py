"""Time kernel K4 (``walk_search``) of this checkout against another
checkout's on one card, at ``chip_smoke.py``'s call shapes, in turns:

    python tools/time_walk.py [--parent DIR] [--packed] [--sweep] [--iters N]

The operands are made once, by this checkout: ``chip_smoke.py``'s random
valid graph (65,536 nodes, K = 64, D 128 and 300, 1024 queries, expand
2) and, with ``--packed``, the packed serving calls of the smoke's
``packed`` and ``packed300`` paths (1M x 128 and 1M x 300 builds of its
configurations, ``PackedHnsw.from_index``, 8192 queries, seed-scan
beams; ~4 minutes of builds).  ``DIR/instant_distance_tpu_torch/csrc/
walk_kernel.cu`` is compiled by ``nvcc`` with this checkout's flags and
called through the C entry its source declares (a K4 from before the
redesign takes a merge flag: 1, "count", its default).  At each shape the
two run parent, this, this, parent (CUDA-event means), and every output
must equal this checkout's ``walk_search_plain``.  ``--sweep`` also times
this checkout's kernel at 8,192 to 40,960 bytes of staged codes, with
its shared memory a block and blocks an SM.

Needs a CUDA card.  Prints the card's name and power limit, a line a
case, then one JSON object ``{"ms": {"shape kernel": ms}}``.  Compare
only times taken together in one run.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: Staged-code bytes of --sweep.
SWEEP = (40960, 20480, 16384, 8192)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _parent_entry(root: str):
    """(C function, its int parameter names) of ``root``'s K4, built
    here."""
    from instant_distance_tpu_torch.ops import _build

    src = os.path.join(root, "instant_distance_tpu_torch", "csrc",
                       "walk_kernel.cu")
    with open(src) as f:
        decl = re.search(r'extern "C" int idt_walk_search\((.*?)\)',
                         f.read(), re.S).group(1)
    ints = re.findall(r"\bint (\w+)", decl)
    out = os.path.join(_build.BUILD_DIR, "parent_walk_kernel.so")
    _build._compile({src: out})
    fn = ctypes.CDLL(out).idt_walk_search
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * len(ints) + [
        ctypes.c_void_p]
    return fn, ints


def _call(torch, fn, ints, args, values):
    """One launch of C entry ``fn`` on ``args``; ``values`` names the int
    arguments.  Returns (bd, bp)."""
    queries, bd0 = args[0], args[1]
    bd = torch.empty_like(bd0)
    bp = torch.empty(bd0.shape, dtype=torch.int32, device=bd0.device)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*(t.data_ptr() for t in args), bd.data_ptr(), bp.data_ptr(),
            *(values[name] for name in ints), stream)
    if rc:
        raise RuntimeError(f"walk_search failed to launch ({rc})")
    return bd, bp


def _shapes(torch, smoke, dev, packed: bool):
    """{shape label: walk_search arguments} of the smoke's calls."""
    from instant_distance_tpu_torch.ops import packed as pk

    out = {}
    for d in (smoke.DIM, smoke.DIM300):
        g = torch.Generator(device=dev).manual_seed(d)
        pts = torch.randn((smoke.WALK_N, d), generator=g, device=dev)
        zero = pk.pack_layer(
            smoke._random_graph(torch, smoke.WALK_N, smoke.WALK_K, g, dev),
            *pk.quantize_points(pts))
        queries = torch.randn((smoke.WALK_B, d), generator=g, device=dev)
        beams = pk.seeded_beam(queries, pts[:smoke.WALK_S].to(
            torch.bfloat16), smoke.WALK_EF)
        out[f"random graph D={d}"] = (queries, *beams, *zero)
    if packed:
        import instant_distance_tpu_torch as idt
        from instant_distance_tpu_torch.utils.datasets import \
            synthetic_clustered

        for d, seed in ((smoke.DIM, 3), (smoke.DIM300, 5)):
            data = synthetic_clustered(smoke.N_POINTS + smoke.N_QUERIES, d,
                                       n_clusters=10000, seed=seed)
            pts = torch.from_numpy(data[:smoke.N_POINTS]).to(dev)
            queries = torch.from_numpy(data[smoke.N_POINTS:]).to(dev)
            del data
            index, _ = idt.Hnsw.build(pts, idt.Config(
                seed=seed, m=32, wave_size=4096, ef_search=50))
            del pts
            packed = idt.PackedHnsw.from_index(index)
            del index
            beams = pk.seeded_beam(queries, packed.points[:smoke.PACKED_KW[
                "entry_seeds"]].to(torch.bfloat16), smoke.PACKED_KW["ef"])
            out[f"packed call D={d}"] = (queries, *beams, *packed.zero_pack)
            del packed
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout whose K4 is timed beside")
    ap.add_argument("--packed", action="store_true",
                    help="also the packed serving calls (1M builds)")
    ap.add_argument("--sweep", action="store_true",
                    help="also this K4 at other staging sizes")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_walk: no CUDA device", file=sys.stderr)
        return 1
    from instant_distance_tpu_torch.ops import _build
    from instant_distance_tpu_torch.ops import walk_kernel as wk

    smoke = _smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda", 0)
    lib = _build.library()
    this = (lib.idt_walk_search,
            ["b", "d", "k", "ef", "expand", "max_iters", "stage_cap"])
    kernels = {"this": this}
    if args.parent:
        kernels["parent"] = _parent_entry(os.path.abspath(args.parent))
    ms = {}
    ef, expand = smoke.PACKED_KW["ef"], smoke.PACKED_KW["expand"]
    for shape, ops in _shapes(torch, smoke, dev, args.packed).items():
        b, d = ops[0].shape
        k = ops[3].shape[1]
        values = dict(b=b, d=d, k=k, ef=ef, expand=expand,
                      max_iters=8 * ef + 16, count=1,
                      stage_cap=wk.STAGE_BYTES)
        want = wk.walk_search_plain(*ops, expand=expand, ef=ef,
                                    max_iters=values["max_iters"])
        order = ["parent", "this", "this", "parent"] if args.parent else \
            ["this", "this"]
        runs = [(name, values) for name in order]
        if args.sweep:
            runs += [(f"this stage={s}", dict(values, stage_cap=s))
                     for s in SWEEP]
        times = {}
        for name, vals in runs:
            fn, ints = kernels[name.split()[0]]
            got = _call(torch, fn, ints, ops, vals)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{shape} {name}: differs from plain")
            t = smoke._cuda_ms(torch, lambda: _call(torch, fn, ints, ops,
                                                    vals), args.iters)
            times.setdefault(name, []).append(t)
            s = vals["stage_cap"]
            print(f"{shape} {name}: {t:.4f} ms; this K4 at stage={s}: "
                  f"{lib.idt_walk_smem(d, k, ef, expand, s)} B a block, "
                  f"{lib.idt_walk_occupancy(d, k, ef, expand, s)} blocks an "
                  "SM", flush=True)
        for name, ts in times.items():
            ms[f"{shape} {name}"] = sum(ts) / len(ts)
        del ops, want
        torch.cuda.empty_cache()
    print(json.dumps({"ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
