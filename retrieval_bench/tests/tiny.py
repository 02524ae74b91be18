"""Overrides that cut each cell to a size a CPU test run holds (resnet at
64 px, a 1,000-row gallery of 256 dimensions); the code paths are the
cells' own."""

TINY_SEARCH = {"config": {"index": {"gallery_rows": 1000, "whiten_in": 256, "whiten_out": 256},
                          "gallery": {"clusters": 50}},
               "traffic": {"query_pool": 100, "warm_calls": 2, "check_queries": 40,
                           "trace_seconds": 0.5}}
_EXTRACT_TRAFFIC = {"list_images": 8, "pool_per_shape": 3, "warm_batches_per_shape": 1,
                    "trace_seconds": 0.5, "host_batch_seconds": 0.2, "check_images": 4}
TINY = {
    "aachen-1m-pod.search-q20-k100": TINY_SEARCH,
    "aachen-1m-pod.search-q1-k100": TINY_SEARCH,
    "r50-gem-pca-roxford5k.extract-db": {
        "config": {"extract": {"image_size": 64, "batch_size": 4},
                   "images": {"shapes": [[48, 64], [64, 48]], "mix": [3, 1]}},
        "traffic": _EXTRACT_TRAFFIC},
    "aachen-1m-pod.extract-db": {
        "config": {"extract": {"image_size": 64, "batch_size": 2},
                   "images": {"shapes": [[48, 64], [43, 64], [64, 48], [64, 43]],
                              "mix": [1, 1, 1, 1]}},
        "traffic": _EXTRACT_TRAFFIC},
}
