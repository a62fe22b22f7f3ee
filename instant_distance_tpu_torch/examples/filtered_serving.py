"""Filtered + mutable serving demo: ScanIndex and Hnsw with metadata.

The reference's examples (colors.rs, translate.py) build an immutable
index and query it.  This example shows the beyond-parity serving
surface: metadata filtering, tombstone deletes, and incremental adds —
on both the graph index and the quantized-scan index.

Run: python -m instant_distance_tpu_torch.examples.filtered_serving
     [--device cpu]
"""

import argparse

import numpy as np

import instant_distance_tpu_torch as idt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(7)
    n, dim = 5000, 64
    points = rng.standard_normal((n, dim)).astype(np.float32)
    # fake metadata: a category per point
    category = rng.integers(0, 4, size=n)

    # --- quantized-scan serving (exact filtering) ------------------------
    scan = idt.ScanIndex(points, values=[f"item-{i}" for i in range(n)],
                         device=args.device)
    q = points[:4] + 0.01

    d, i = scan.search_batch(q, k=3)
    print("unfiltered:", i.cpu().numpy()[:, 0])

    only_cat0 = category == 0
    d, i, vals = scan.search_batch_values(q, k=3, filter_mask=only_cat0)
    ids = i.cpu().numpy()
    assert (category[ids[ids >= 0]] == 0).all()
    print("category-0 only:", ids[:, 0], vals[0][0])

    scan.delete(ids[:, 0])                     # tombstone the top hits
    d, i2 = scan.search_batch(q, k=3, filter_mask=only_cat0)
    assert not np.isin(i2.cpu().numpy()[:, 0], ids[:, 0]).any()
    print("after delete:", i2.cpu().numpy()[:, 0])

    # --- graph index with incremental adds -------------------------------
    cfg = idt.Config(seed=7, ef_search=48, wave_size=256)
    index, pid_map = idt.Hnsw.build(points[: n // 2], cfg,
                                    device=args.device)
    new_pids = index.add(points[n // 2:])      # grow the index
    d, p = index.search_batch(points[n // 2: n // 2 + 4], k=1, ef=32)
    hit = (p.cpu().numpy()[:, 0] == new_pids[:4]).mean()
    print(f"added points find themselves: {hit:.2f}")
    assert hit >= 0.75


if __name__ == "__main__":
    main()
