"""Exact top-k search (kernel B4, ``fused_topk_search``): the least work a
call needs. Bytes: the gallery, the f32 queries and the (score, id) lists,
each once. FLOPs: ``2 Nq Ng D``, at the peak of the gallery's storage
dtype's tensor cores (float32 without TF32: the FMA peak)."""

from retrieval_bench.roofline import ELEMENT_BYTES, flops_peak, hbm_bytes_per_s


def work(nq: int, ng: int, d: int, k: int, storage: str) -> dict:
    k = min(k, ng)
    nbytes = ng * d * ELEMENT_BYTES[storage] + nq * d * 4 + nq * k * (4 + 4)
    flops = 2 * nq * ng * d
    s_bytes = nbytes / hbm_bytes_per_s()
    s_flops = flops / flops_peak(storage)
    return {"bytes": nbytes, "flops": flops, "bytes_s": s_bytes, "flops_s": s_flops,
            "bound_s": max(s_bytes, s_flops)}
