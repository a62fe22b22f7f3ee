"""The scan route: ``ScanIndex(points)`` in set-up, then
``ScanIndex.search_batch(queries, k, **search)`` a call (with
``fused="bucket_pack"``: the query quantization, K1, the top-ef
selection and the exact rerank).  Ids are the points' order."""

import instant_distance_tpu_torch as idt


class Served:
    def __init__(self, points, spec, params):
        self.index = idt.ScanIndex(points, metric=spec["metric"])
        self.kw = dict(params["search"], k=spec["k"])
        self.shape = dict(n=points.shape[0], d=points.shape[1])

    def search(self, queries):
        return self.index.search_batch(queries, **self.kw)

    def input_ids(self, ids):
        return ids

    def checks(self):
        return {}

    def layers(self, queries):
        """K1's call shape, where the route runs K1."""
        if self.kw.get("fused") != "bucket_pack":
            return {}
        return {"k1": dict(self.shape, b=queries.shape[0],
                           lsub=self.kw["lsub"])}

    def close(self):
        self.index = None


def setup(points, spec, params, seed, counters):
    return Served(points, spec, params)
