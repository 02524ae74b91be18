"""The GeM + L2N head kernels (B1 ``gem_l2n_fused_rect``, B2
``gem_l2n_fused``): the bytes one image needs, which bound them. The valid
rectangle of the feature map is read once (a padded map's invalid cells
need no read), the f32 descriptor written once, and the exponent and the
extents read once."""

from retrieval_bench.roofline import ELEMENT_BYTES, hbm_bytes_per_s


def valid_cells(h_px: int, w_px: int, H_px: int, W_px: int, fh: int, fw: int) -> int:
    """Feature cells of an image of ``h_px`` x ``w_px`` valid pixels in a
    bucket of ``H_px`` x ``W_px`` whose map is ``fh`` x ``fw``: the mask is
    taken at stride ``H_px // fh`` (``W_px // fw``) and cut to the map, so a
    cell is valid where its first pixel is."""
    sh, sw = H_px // fh, W_px // fw
    rows = min(fh, -(-h_px // sh))
    cols = min(fw, -(-w_px // sw))
    return rows * cols


def scaled(n: int, s: float) -> int:
    """A padded side at scale ``s``, as the extractor resizes it."""
    return n if s == 1.0 else max(int(n * s), 32)


def mask_rows(valid: int, n_in: int, n_out: int) -> int:
    """Rows of a nearest-resized mask (``n_in`` -> ``n_out``) that stay
    valid: row i reads input row floor((i + 0.5) * n_in / n_out)."""
    if n_in == n_out:
        return valid
    return sum(1 for i in range(n_out) if int((i + 0.5) * n_in / n_out) < valid)


def image_bytes(cells: int, channels: int, dtype: str) -> int:
    return cells * channels * ELEMENT_BYTES[dtype] + channels * 4 + 4 + 8


def seconds(total_bytes: int) -> float:
    return total_bytes / hbm_bytes_per_s()
