"""The NetVLAD head kernels (B5 ``netvlad_fused``, B6 ``netvlad_fused_rect``):
the least time one image's aggregation needs. FLOPs: the two products (the
logits x W and the aggregation a^T x), 2 N C K each over the image's N valid
rows, at the TF32 peak over three (a 3xTF32 product, the fastest f32-accurate
product on this card). Bytes: the valid rows of x read once, W [C, K] and
the centroids [K, C] read once, the [K C] f32 descriptor written once. The
bound is the larger of the two times."""

from retrieval_bench.roofline import flops_peak, hbm_bytes_per_s


def work(n_valid: int, channels: int, clusters: int) -> dict:
    flops = 4 * n_valid * channels * clusters
    nbytes = 4 * (n_valid * channels + 3 * channels * clusters)
    s_bytes = nbytes / hbm_bytes_per_s()
    s_flops = flops / (flops_peak("tf32") / 3)
    return {"bytes": nbytes, "flops": flops, "bytes_s": s_bytes, "flops_s": s_flops,
            "bound_s": max(s_bytes, s_flops)}
