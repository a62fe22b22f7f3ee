"""Streaming-ingestion demo: serve while the index grows.

The reference's index is frozen at build (SURVEY.md §5: no add/delete
anywhere in lib.rs).  StreamingHnsw keeps a compiled serving form (the
packed graph or the quantized scan) current under chunked ingestion:
new chunks insert into the owned graph, rows newer than the serving
snapshot are scanned exactly and merged (a just-added point is
immediately findable), and the serving form recompiles automatically
once the pending slab outgrows ``repack_every``.

Run: python -m instant_distance_tpu_torch.examples.streaming_ingest
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

    rng = np.random.default_rng(42)
    dim = 32
    base = rng.standard_normal((4000, dim)).astype(np.float32)

    cfg = idt.Config()
    cfg.ef_search = 64
    idx = idt.StreamingHnsw.build(
        base, values=[f"doc-{i}" for i in range(len(base))], config=cfg,
        serving="scan", repack_every=1024, device=args.device)
    print(f"built: {len(idx)} points, serving={idx.serving_mode}")

    # stream new documents in chunks while serving
    for step in range(4):
        chunk = rng.standard_normal((400, dim)).astype(np.float32)
        pids = idx.add(chunk, values=[f"new-{step}-{j}"
                                      for j in range(len(chunk))])
        # read-your-writes: the chunk's first vector is already findable
        d, p, v = idx.search_batch_values(chunk[0][None], k=1)
        assert int(p[0][0]) == pids[0] and v[0][0] == f"new-{step}-0"
        print(f"step {step}: n={len(idx)} pending={idx.n_pending} "
              f"(top hit for a just-added doc: {v[0][0]}, "
              f"dist {float(d[0][0]):.3f})")

    idx.compact()
    print(f"compacted: n={len(idx)} pending={idx.n_pending}")
    d, p, v = idx.search_batch_values(base[7][None], k=3)
    print("query near doc-7 ->", v[0])


if __name__ == "__main__":
    main()
