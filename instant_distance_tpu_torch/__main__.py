"""Command-line tools: build, search, inspect, validate, convert (port of
``instant_distance_tpu/__main__.py``).

Usage:
  python -m instant_distance_tpu_torch build VECTORS.npy OUT [--m --efc ...]
  python -m instant_distance_tpu_torch search INDEX QUERIES.npy [--k K --ef E]
  python -m instant_distance_tpu_torch info INDEX [--dims D]
  python -m instant_distance_tpu_torch validate INDEX [--dims D]
  python -m instant_distance_tpu_torch convert SRC DST [--dims D]
  python -m instant_distance_tpu_torch selftest INDEX [--dims D] [--queries Q]

Every subcommand also takes ``--device`` (default: the CUDA card; pass
``--device cpu`` to run on the CPU).  INDEX may be native .npz or a
reference bincode dump (auto-detected; bincode needs --dims unless it is
the binding's fixed 300).  The same subcommands, options and output as
the JAX package's CLI, over the same index files.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load(path: str, dims: int, device):
    from .utils import serialize

    kw = {}
    with open(path, "rb") as f:
        if not f.read(4).startswith(b"PK"):
            kw["dims"] = dims
    return serialize.load(path, device=device, **kw)


def _host(x):
    """A tensor (or array) as numpy."""
    import numpy as np

    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _device(args):
    from .utils.convert import default_device

    return default_device(args.device)


def cmd_info(args) -> int:
    import numpy as np

    idx = _load(args.index, args.dims, _device(args))
    info = {
        "type": type(idx).__name__,
        "points": int(idx.points.shape[0]),
        "dims": int(idx.points.shape[1]) if idx.points.ndim == 2 else 0,
        "values": len(getattr(idx, "values", []) or []),
    }
    if hasattr(idx, "zero"):  # graph indices
        zero = _host(idx.zero)
        degrees = (zero >= 0).sum(axis=1) if zero.size else np.zeros(0)
        info.update(
            m=idx.config.m,
            ef_search=idx.config.ef_search,
            layers=[int(l.shape[0]) for l in idx.layers],
            mean_degree=float(degrees.mean()) if degrees.size else 0.0)
    else:  # scan indices: no graph, quantized serving arrays
        info.update(metric=idx.metric_name,
                    codes_dtype=str(_host(idx.codes).dtype))
    print(json.dumps(info, indent=2))
    return 0


def cmd_validate(args) -> int:
    import numpy as np

    from .utils.validate import validate_graph

    idx = _load(args.index, args.dims, _device(args))
    if not hasattr(idx, "zero"):  # scan index: array-consistency checks
        n = len(idx)
        errors = []
        if idx.codes.shape[0] != n:
            errors.append(f"codes rows {idx.codes.shape[0]} != {n}")
        if tuple(idx.scales.shape) != (n,):
            errors.append(f"scales shape {tuple(idx.scales.shape)} != "
                          f"({n},)")
        if tuple(idx.norms.shape) != (n,):
            errors.append(f"norms shape {tuple(idx.norms.shape)} != ({n},)")
        if not bool(np.isfinite(_host(idx.norms)).all()):
            errors.append("non-finite norms")
        print(json.dumps({"ok": not errors, "errors": errors, "n": n,
                          "type": type(idx).__name__}, indent=2))
        return 0 if not errors else 1
    rep = validate_graph(idx)
    print(json.dumps({
        "ok": rep.ok, "errors": rep.errors, "n": rep.n,
        "mean_degree": round(rep.mean_degree, 2),
        "degree_histogram": rep.degree_histogram,
        "n_layers": rep.n_layers}, indent=2))
    return 0 if rep.ok else 1


def cmd_convert(args) -> int:
    idx = _load(args.src, args.dims, _device(args))
    fmt = "bincode" if args.dst.endswith((".bin", ".idx")) else "native"
    if not hasattr(idx, "zero"):
        if fmt == "bincode":
            print("scan indices have no graph: bincode export is for "
                  "graph indices only", file=sys.stderr)
            return 1
        idx.dump(args.dst)
        print(f"wrote {args.dst} (native scan)")
        return 0
    idx.dump(args.dst, format=fmt)
    print(f"wrote {args.dst} ({fmt})")
    return 0


def cmd_selftest(args) -> int:
    """Self-query recall: every point should find itself first, and
    near-neighbor recall vs brute force should be high."""
    import numpy as np

    from .models.brute import BruteForce
    from .utils.metrics import recall_at_k

    idx = _load(args.index, args.dims, _device(args))
    n = len(idx)
    q = idx.points[:min(args.queries, n)].float()
    d, p = idx.search_batch(q, k=min(10, n))
    p = _host(p)
    self_ok = float((p[:, 0] == np.arange(len(q))).mean())
    _, gt_i = BruteForce(idx.points).search_batch(q, min(10, n))
    rec = recall_at_k(p, _host(gt_i), min(10, n))
    print(json.dumps({"self_top1": self_ok,
                      "recall_at_10": round(rec, 4),
                      "queries": len(q)}))
    return 0 if self_ok > 0.9 and rec > 0.9 else 1


def cmd_build(args) -> int:
    """Build an index from an .npy/.npz vector file and dump it."""
    import time

    import numpy as np

    from .config import Config, Heuristic
    from .models.hnsw import Hnsw, HnswMap

    vecs = np.load(args.vectors)
    if hasattr(vecs, "files"):  # npz: take the first array
        vecs = vecs[vecs.files[0]]
    vecs = np.asarray(vecs, np.float32)
    cfg = Config(ef_search=args.ef_search,
                 ef_construction=args.ef_construction,
                 seed=args.seed, metric=args.metric, m=args.m,
                 wave_size=args.wave_size,
                 heuristic=None if args.no_heuristic else Heuristic())
    values = None
    if args.values:
        with open(args.values) as f:
            values = json.load(f)
        if len(values) != len(vecs):
            print(f"error: {len(values)} values for {len(vecs)} vectors",
                  file=sys.stderr)
            return 2

    device = _device(args)
    t0 = time.time()
    if values is not None:
        idx = HnswMap.build(vecs, values, cfg, device=device)
    else:
        idx, _ = Hnsw.build(vecs, cfg, device=device)
    fmt = "bincode" if args.out.endswith((".bin", ".idx")) else "native"
    idx.dump(args.out, format=fmt)
    print(json.dumps({
        "out": args.out, "format": fmt, "points": len(vecs),
        "dims": int(vecs.shape[1]), "build_s": round(time.time() - t0, 2),
        "layers": [int(l.shape[0]) for l in idx.layers],
    }))
    return 0


def cmd_search(args) -> int:
    """Query an index with vectors from an .npy file; JSON-line output."""
    import numpy as np

    idx = _load(args.index, args.dims, _device(args))
    q = np.load(args.queries)
    if hasattr(q, "files"):
        q = q[q.files[0]]
    q = np.asarray(q, np.float32)
    if q.ndim == 1:
        q = q[None]
    d, p = idx.search_batch(q, k=args.k, ef=args.ef)
    d, p = _host(d), _host(p)
    values = getattr(idx, "values", None)
    for qi in range(len(q)):
        row = {"query": qi,
               "ids": [int(x) for x in p[qi] if x >= 0],
               "distances": [round(float(x), 6)
                             for x, i in zip(d[qi], p[qi]) if i >= 0]}
        if values is not None:
            row["values"] = [values[i] for i in p[qi] if i >= 0]
        print(json.dumps(row))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="instant_distance_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn):
        p = sub.add_parser(name)
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")
        p.set_defaults(fn=fn)
        return p

    p = add("build", cmd_build)
    p.add_argument("vectors")
    p.add_argument("out")
    p.add_argument("--m", type=int, default=32,
                   help="graph degree (32 = reference/bincode parity)")
    p.add_argument("--ef-search", type=int, default=100)
    p.add_argument("--ef-construction", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metric", default="sqeuclidean")
    p.add_argument("--wave-size", type=int, default=1024)
    p.add_argument("--no-heuristic", action="store_true")
    p.add_argument("--values", help="JSON list aligned with vectors")
    p = add("search", cmd_search)
    p.add_argument("index")
    p.add_argument("queries")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--ef", type=int, default=None)
    p.add_argument("--dims", type=int, default=300)
    for name, fn in [("info", cmd_info), ("validate", cmd_validate),
                     ("selftest", cmd_selftest)]:
        p = add(name, fn)
        p.add_argument("index")
        p.add_argument("--dims", type=int, default=300)
        if name == "selftest":
            p.add_argument("--queries", type=int, default=256)
    p = add("convert", cmd_convert)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--dims", type=int, default=300)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
