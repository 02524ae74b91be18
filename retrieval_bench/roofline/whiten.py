"""Whitening of a query batch, ``L2N((q - m) @ P.T)`` in float32 without
TF32: bytes of the queries in and out, of m and of P, each once; FLOPs of
the product, ``2 Nq Din Dout``, at the float32 FMA peak."""

from retrieval_bench.roofline import flops_peak, hbm_bytes_per_s


def work(nq: int, d_in: int, d_out: int) -> dict:
    nbytes = 4 * (nq * d_in + d_in + d_out * d_in + nq * d_out)
    flops = 2 * nq * d_in * d_out
    s_bytes = nbytes / hbm_bytes_per_s()
    s_flops = flops / flops_peak("float32")
    return {"bytes": nbytes, "flops": flops, "bytes_s": s_bytes, "flops_s": s_flops,
            "bound_s": max(s_bytes, s_flops)}
