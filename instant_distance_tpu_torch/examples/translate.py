"""Word-vector translation demo — the analogue of the reference's
fastText example (instant-distance-py/examples/translations/translate.py):
build an HnswMap over multilingual word embeddings whose values are
"<lang><word>" strings, dump/load it, and translate by nearest-neighbor
lookup in the shared embedding space.

The reference streams ~100k aligned fastText vectors per language from
the network; nothing is downloaded here, so the demo generates a
synthetic aligned embedding space instead (same API flow, same index
shapes: 300-d points, string values, dump -> load -> search).  Point
fastText .vec files already on disk via --vectors to run it on real
data.

Run: python -m instant_distance_tpu_torch.examples.translate [WORD]
     [--index PATH] [--n-words N] [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

import instant_distance_tpu_torch as idt

LANGS = ("en", "fr", "it")
DIMS = 300


def synthetic_vocab(n_words: int, seed: int = 5):
    """An aligned multilingual space: each concept has one base vector;
    each language's word for it is a small perturbation."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_words, DIMS)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    points, values = [], []
    for lang in LANGS:
        noise = 0.05 * rng.standard_normal((n_words, DIMS)).astype(np.float32)
        vecs = base + noise
        points.append(vecs)
        values.extend(f"{lang}word{i}_{lang}" for i in range(n_words))
    return np.concatenate(points), values


def load_fasttext(paths, max_words=100_000):
    points, values = [], []
    for lang, path in paths:
        with open(path, encoding="utf-8") as f:
            next(f)  # header: count dims
            for i, line in enumerate(f):
                if i >= max_words:
                    break
                parts = line.rstrip().split(" ")
                if len(parts) != DIMS + 1:
                    continue
                values.append(lang + parts[0])
                points.append(np.array(parts[1:], np.float32))
    return np.stack(points), values


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("word", nargs="?", default="word42_en")
    ap.add_argument("--vectors", nargs="*", metavar="LANG:PATH",
                    help="fastText .vec files on disk, e.g. en:cc.en.vec")
    ap.add_argument("--index", default=os.path.join(tempfile.gettempdir(),
                                                    "translate.idx.npz"))
    ap.add_argument("--n-words", type=int, default=20_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if not os.path.exists(args.index):
        t0 = time.time()
        if args.vectors:
            pairs = [v.split(":", 1) for v in args.vectors]
            points, values = load_fasttext(pairs)
        else:
            points, values = synthetic_vocab(args.n_words)
        print(f"building index over {len(points)} vectors...",
              file=sys.stderr)
        map_ = idt.HnswMap.build(points, values, idt.Config(seed=9),
                                 device=args.device)
        map_.dump(args.index)
        print(f"built + dumped in {time.time() - t0:.1f}s", file=sys.stderr)

    map_ = idt.HnswMap.load(args.index, device=args.device)
    # find the query word's embedding by value lookup (the reference keeps
    # a separate word -> embedding JSON; the index itself stores values)
    query_value = "en" + args.word
    try:
        pid = map_.values.index(query_value)
    except ValueError:
        print(f"unknown word {args.word!r}", file=sys.stderr)
        sys.exit(1)
    embedding = map_[pid]

    search = idt.Search()
    print(f"translations for {args.word!r}:")
    shown = 0
    for item in map_.search(embedding, search):
        lang, word = item.value[:2], item.value[2:]
        if lang != "en":
            print(f"  {lang}: {word}  (distance {item.distance:.4f})")
            shown += 1
        if shown >= 10:
            break


if __name__ == "__main__":
    main()
