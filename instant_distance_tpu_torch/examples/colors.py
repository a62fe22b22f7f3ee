"""RGB color k-NN — the reference's smallest example
(instant-distance/examples/colors.rs): build a 3-point map, query burnt
orange, print the nearest color name.  Expected output: red.

Run: python -m instant_distance_tpu_torch.examples.colors [--device cpu]
"""

import argparse

import numpy as np

import instant_distance_tpu_torch as idt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    points = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.float32)
    values = ["red", "green", "blue"]

    map_ = idt.HnswMap.build(points, values, idt.Config(metric="euclidean"),
                             device=args.device)
    search = idt.Search()

    burnt_orange = np.array([204, 85, 0], np.float32)
    closest = next(iter(map_.search(burnt_orange, search)))
    print(closest.value)


if __name__ == "__main__":
    main()
