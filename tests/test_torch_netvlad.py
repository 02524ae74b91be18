"""Port parity: NetVLAD's aggregation and the fused kernels' plain version
(what the kernel wrappers run on CPU tensors) against the JAX package's
``netvlad_aggregate`` and its Pallas kernels in interpret mode, at rtol 1e-4
/ atol 1e-5 (the JAX suite's own bound for these kernels)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from irtpu.ops.netvlad import netvlad_aggregate as j_aggregate
from irtpu.ops.pallas import netvlad_fused as j_fused
from irtpu.ops.pallas import netvlad_fused_rect as j_rect

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    netvlad_fused,
    netvlad_fused_rect,
    netvlad_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bottleneck import (
    split_tf32,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.netvlad import (
    EPS,
    _plan,
    prepare_operands,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.netvlad import netvlad_aggregate
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

RTOL, ATOL = 1e-4, 1e-5
B, H, W, C, K = 3, 5, 7, 32, 8
SIZES = np.array([[5, 7], [0, 0], [3, 4]], np.int32)  # full extent, batch pad, ragged


def _inputs(seed=0, shape=(B, H, W, C)):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(*shape)).astype(np.float32)
    c = rng.randn(K, C).astype(np.float32)
    w = (rng.randn(C, K) / np.sqrt(C)).astype(np.float32)
    b = (0.1 * rng.randn(K)).astype(np.float32)
    return x, c, w, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("layout", ["bnc", "bhwc"])
def test_aggregate_matches_jax(masked, layout):
    x, c, w, b = _inputs(1)
    mask = np.random.RandomState(2).rand(B, H, W) > 0.3
    if layout == "bnc":
        x, mask = x.reshape(B, H * W, C), mask.reshape(B, H * W)
    m = mask if masked else None
    got = netvlad_aggregate(*_t(x, c, w, b),
                            mask=None if m is None else torch.from_numpy(m)).numpy()
    want = np.asarray(j_aggregate(*_j(x, c, w, b), mask=None if m is None else jnp.asarray(m)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_fused_matches_pallas(bias):
    x, c, w, b = _inputs(3)
    tb = torch.from_numpy(b) if bias else None
    got = netvlad_fused(*_t(x, c, w), tb).numpy()
    want = np.asarray(j_fused(*_j(x, c, w), jnp.asarray(b) if bias else None,
                              chunk=32, interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_rect_matches_pallas():
    x, c, w, b = _inputs(4)
    got = netvlad_fused_rect(*_t(x, c, w, b), sizes=torch.from_numpy(SIZES)).numpy()
    want = np.asarray(j_rect(*_j(x, c, w, b), sizes=jnp.asarray(SIZES), chunk=32,
                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(got[1] == 0.0)  # an empty (0, 0) batch-pad row
    np.testing.assert_allclose(np.linalg.norm(got[[0, 2]], axis=1), 1.0, atol=1e-5)


def test_plain_matches_masked_oracle():
    """The kernels' plain version against the port's own oracle with the
    rectangle as a mask (the oracle's 1e-24 floor differs only on norms
    below 1e-12)."""
    x, c, w, b = _inputs(5)
    mask = np.zeros((B, H, W), bool)
    for r, (h, wv) in enumerate(SIZES):
        mask[r, :h, :wv] = True
    got = netvlad_plain(*_t(x, c, w, b), sizes=torch.from_numpy(SIZES))
    want = netvlad_aggregate(*_t(x, c, w, b), mask=torch.from_numpy(mask))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    full = torch.from_numpy(np.array([[H, W]] * B, np.int32))
    torch.testing.assert_close(netvlad_fused_rect(*_t(x, c, w, b), sizes=full),
                               netvlad_fused(*_t(x, c, w, b)), rtol=0, atol=1e-7)


def test_zero_mass_clusters_give_zero_rows():
    """Features far along one direction put every row in a few clusters;
    the others get exactly zero soft mass, and their rows come out as 0."""
    x, c, w, b = _inputs(6)
    u = np.abs(np.random.RandomState(7).randn(C)).astype(np.float32)
    x[0] = 100.0 * u + 0.1 * x[0]
    got = netvlad_fused_rect(*_t(x, c, w, b), sizes=torch.from_numpy(SIZES)).numpy()
    want = np.asarray(j_rect(*_j(x, c, w, b), sizes=jnp.asarray(SIZES), chunk=32,
                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    rows = got[0].reshape(K, C)
    zero = np.all(rows == 0.0, axis=1)
    assert 0 < zero.sum() < K
    np.testing.assert_array_equal(np.all(want[0].reshape(K, C) == 0.0, axis=1), zero)


def test_grad_and_dtype_are_refused():
    """A non-f32 input is refused. Inputs that need a gradient are no longer
    refused: they go through the autograd Function (its gradients are held
    against the JAX VJP in test_torch_head_grad.py)."""
    x, c, w, b = _t(*_inputs(8))
    out = netvlad_fused(x.requires_grad_(), c, w, b)
    assert type(out.grad_fn).__name__ == "_NetVLADBackward"
    out = netvlad_fused_rect(x.detach(), torch.nn.Parameter(c), w, b,
                             sizes=torch.from_numpy(SIZES))
    assert type(out.grad_fn).__name__ == "_NetVLADBackward"
    with torch.no_grad():  # parameters that require grad build no graph
        assert netvlad_fused(x, torch.nn.Parameter(c), w, b).grad_fn is None
    with pytest.raises(TypeError, match="float32"):
        netvlad_fused(x.detach().to(torch.bfloat16), c, w, b)


def test_cpu_path_never_counts_a_launch():
    x, c, w, b = _t(*_inputs(9))
    before = (netvlad_fused.launches, netvlad_fused_rect.launches)
    netvlad_fused(x, c, w, b)
    netvlad_fused_rect(x, c, w, b, sizes=torch.from_numpy(SIZES))
    assert (netvlad_fused.launches, netvlad_fused_rect.launches) == before


# ---- the kernel's operands at any K and any C -----------------------------

K_BIG, C_ODD = 160, 37  # past the old 128-cluster limit; not a multiple of 32


def _inputs_kc(seed, k, c):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(B, H, W, c)).astype(np.float32)
    cen = rng.randn(k, c).astype(np.float32)
    w = (rng.randn(c, k) / np.sqrt(c)).astype(np.float32)
    b = (0.1 * rng.randn(k)).astype(np.float32)
    return x, cen, w, b


@pytest.mark.parametrize("C_", [C_ODD, 64])
@pytest.mark.parametrize("entry", ["fused", "rect"])
def test_large_k_ragged_c_match_pallas(entry, C_):
    """Both entry points at K = 160 and C = 37 or 64 against the Pallas
    kernels in interpret mode (rtol 1e-4 / atol 1e-5)."""
    x, c, w, b = _inputs_kc(11, K_BIG, C_)
    if entry == "fused":
        got = netvlad_fused(*_t(x, c, w, b)).numpy()
        want = np.asarray(j_fused(*_j(x, c, w, b), chunk=32, interpret=True))
    else:
        got = netvlad_fused_rect(*_t(x, c, w, b), sizes=torch.from_numpy(SIZES)).numpy()
        want = np.asarray(j_rect(*_j(x, c, w, b), sizes=jnp.asarray(SIZES), chunk=32,
                                 interpret=True))
        assert np.all(got[1] == 0.0)
    assert got.shape == (B, K_BIG * C_)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def wt_planes(w: torch.Tensor, k: int) -> tuple:
    """The planes csrc/netvlad.cu's first kernel writes from w [Cp, K]: W^T
    [KP, Cp] zero past row K, split by ``split_tf32`` (the card test holds
    the kernel's bits to these)."""
    kp = -(-k // 64) * 64
    return split_tf32(torch.nn.functional.pad(w.t(), (0, 0, 0, kp - k)))


@pytest.mark.parametrize("k,c", [(8, 32), (64, 512), (100, 96), (K_BIG, C_ODD), (256, 100)])
def test_operand_padding_and_planes(k, c):
    """x, the centroids and w are zero-padded to Cp, the next multiple of 32
    (no copy of x when C % 32 == 0); W^T's planes [KP, Cp]: hi has its 13
    low mantissa bits zero, hi + lo rebuilds w to 2^-22 |w|, zeros past row
    K and column C."""
    x, cen, w, _ = _inputs_kc(12, k, c)
    x3 = torch.from_numpy(x.reshape(B, H * W, c))
    xp, cp_, wp = prepare_operands(x3, torch.from_numpy(cen), torch.from_numpy(w))
    cpad, kpad = -(-c // 32) * 32, -(-k // 64) * 64
    assert xp.shape == (B, H * W, cpad) and cp_.shape == (k, cpad) and wp.shape == (cpad, k)
    assert all(t.is_contiguous() for t in (xp, cp_, wp))
    assert torch.equal(xp[..., :c], x3) and torch.all(xp[..., c:] == 0)
    assert torch.equal(cp_[:, :c], torch.from_numpy(cen)) and torch.all(cp_[:, c:] == 0)
    assert torch.equal(wp[:c], torch.from_numpy(w)) and torch.all(wp[c:] == 0)
    if c % 32 == 0:
        assert xp is x3  # no copy of the feature map when no padding is needed
    hi, lo = wt_planes(wp, k)
    assert hi.shape == lo.shape == (kpad, cpad)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    wt = torch.from_numpy(w).t().double()
    err = (wt - hi[:k, :c].double() - lo[:k, :c].double()).abs()
    assert torch.all(err <= 2.0 ** -22 * wt.abs())
    assert torch.all(hi[k:] == 0) and torch.all(lo[k:] == 0)
    assert torch.all(hi[:, c:] == 0) and torch.all(lo[:, c:] == 0)


@pytest.mark.parametrize("n,k,chunks", [(117, 8, 1), (512, 64, 1), (513, 64, 2),
                                        (4096, 64, 8), (2400, 129, 5)])
def test_plan_scratch_shapes(n, k, chunks):
    """Scratch as csrc/netvlad.cu's entry documents it, in its order: NP = N
    rounded up to 32, KP = K rounded up to 64, one partial per 512-row
    chunk."""
    plan = _plan(2, n, 96, k)
    np_, kp = -(-n // 32) * 32, -(-k // 64) * 64
    assert plan["n_chunks"] == chunks
    assert plan["scratch"] == {"wt_hi": (kp, 96), "wt_lo": (kp, 96), "logits": (2, np_, kp),
                               "a_hi": (2, k, np_),
                               "a_lo": (2, k, np_), "mass": (2, np_ // 32, k),
                               "part": (2, chunks, k, 96), "row_sq": (2, k)}


def _tf32x3_dot(a, b):
    """a @ b under the kernel's rule: lo_a hi_b + hi_a lo_b + hi_a hi_b."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_kernel_arithmetic_written_out_matches_pallas(masked):
    """The card kernel's arithmetic in torch, f64 sums: logits from the
    padded W^T planes (x split as the mainloop splits it), the softmax, a
    rounded to its hi/lo planes, the aggregation under the same rule, at K =
    160 and C = 37, within the suite's bound of the Pallas kernels."""
    x, c, w, b = _inputs_kc(13, K_BIG, C_ODD)
    x3 = torch.from_numpy(x.reshape(B, H * W, C_ODD))
    xp, cen, wp = prepare_operands(x3, *_t(c, w))
    hi, lo = wt_planes(wp, K_BIG)
    xh, xl = (t.double() for t in split_tf32(xp))
    logits = xl @ hi.double().T + xh @ lo.double().T + xh @ hi.double().T
    logits = (logits[..., :K_BIG] + torch.from_numpy(b).double()).float()
    a = torch.softmax(logits, dim=-1)
    if masked:
        n = torch.arange(H * W)
        s = torch.from_numpy(SIZES).long()
        valid = ((n // W)[None] < s[:, :1]) & ((n % W)[None] < s[:, 1:])
        a = torch.where(valid[..., None], a, torch.zeros(()))
    ah, al = (t.double() for t in split_tf32(a))
    agg = (ah.transpose(1, 2) @ xl + al.transpose(1, 2) @ xh + ah.transpose(1, 2) @ xh)
    assert torch.all(xh[..., C_ODD:] == 0) and torch.all(xl[..., C_ODD:] == 0)
    vlad = agg - a.double().sum(1)[..., None] * cen.double()
    vlad = vlad / (vlad.norm(dim=-1, keepdim=True) + EPS)
    flat = vlad[..., :C_ODD].reshape(B, -1)
    got = (flat / (flat.norm(dim=-1, keepdim=True) + EPS)).float().numpy()
    if masked:
        want = j_rect(*_j(x, c, w, b), sizes=jnp.asarray(SIZES), chunk=32, interpret=True)
    else:
        want = j_fused(*_j(x, c, w, b), chunk=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
