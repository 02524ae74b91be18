"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. Run them on
a machine with an H100 and nvcc (``--noconftest`` because the suite's
``conftest.py`` imports JAX, which such a machine need not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    adc_scores,
    adc_scores_plain,
    blockmax_topk_search,
    bottleneck_fused,
    bottleneck_fused_bf16,
    bottleneck_plain,
    fused_topk_plain,
    fused_topk_search,
    gem_l2n_fused,
    gem_l2n_fused_rect,
    gem_l2n_plain,
    netvlad_fused,
    netvlad_fused_rect,
    netvlad_plain,
    pack_bf16,
    scores_blockmax,
    scores_blockmax_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
    NEG_INF,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    knn_search,
    score_matrix,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import adc_topk_core
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")  # the package's device rule: TF32 off


def _rand(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).abs().to(dev).to(dtype)


@pytest.mark.parametrize("C", [256, 300, 1664, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gem_kernels_match_plain(dev, dtype, C):
    """One cluster of eight CTAs per image: (0, 0) rows, images with fewer
    valid positions than the cluster has CTAs, C = 300 (bf16: the scalar
    path) and the trunks' widths 256 (alexnet), 1,664 (densenet169) and
    2,048, within 1e-5 of plain and the same bits on a second call."""
    x = _rand((7, 5, 7, C), 0, dev, dtype)
    sizes = torch.tensor([[5, 7], [0, 0], [3, 2], [1, 7], [5, 1], [2, 6], [1, 1]],
                         dtype=torch.int32, device=dev)
    p = torch.tensor([3.0], device=dev)
    got = gem_l2n_fused_rect(x, p, sizes)
    torch.testing.assert_close(got, gem_l2n_plain(x, p, sizes), rtol=0, atol=1e-5)
    assert torch.all(got[1] == 0)
    assert torch.equal(got, gem_l2n_fused_rect(x, p, sizes))
    got = gem_l2n_fused(x, p)
    torch.testing.assert_close(got, gem_l2n_plain(x, p), rtol=0, atol=1e-5)
    assert torch.equal(got, gem_l2n_fused(x, p))


@pytest.mark.parametrize("arch", ["alexnet", "squeezenet1_1", "densenet121"])
def test_other_trunks_reach_the_gem_kernels(dev, arch):
    """The kernel head of the other trunks on a padded bucket (B1) and on
    whole images (B2) against the plain head, with one launch each."""
    from image_retrieval_for_image_based_localization_tpu_torch.models import (
        RetrievalNet,
        init_random_,
    )

    net = RetrievalNet(arch, "gem", use_kernel=True)
    init_random_(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    x = _rand((2, 160, 224, 3), 2, dev)
    mask = torch.zeros((2, 160, 224), dtype=torch.bool, device=dev)
    mask[0] = True
    mask[1, :120, :200] = True
    x = x * mask[..., None]
    with torch.no_grad():
        for m, fn in ((mask, gem_l2n_fused_rect), (None, gem_l2n_fused)):
            before = fn.launches
            got = net(x, m)
            assert fn.launches == before + 1
            net.use_kernel = False
            want = net(x, m)
            net.use_kernel = True
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_gem_kernel_refuses_more_channels_than_a_cluster_holds(dev):
    """C > 8,192 (8 channels x 1,024 threads) is refused by the C entry, not
    computed wrong (ROADMAP C3)."""
    x = _rand((1, 2, 2, 8200), 1, dev)
    with pytest.raises(RuntimeError, match="gem_l2n_forward"):
        gem_l2n_fused(x, 3.0)


def test_gem_launches_are_named_in_a_profile_trace(dev, tmp_path):
    """Under ``utils.metrics.profile_trace`` each GeM launch is a range named
    after its entry point, around one ``gem_l2n_kernel`` on the card; and
    ``utils.debug`` passes the kernel's finite, repeatable output."""
    from image_retrieval_for_image_based_localization_tpu_torch.utils.debug import (
        assert_deterministic,
        debug_checks,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
        profile_trace,
    )

    x = _rand((4, 8, 8, 2048), 13, dev)
    sizes = torch.tensor([[8, 8], [5, 8], [8, 3], [1, 1]], dtype=torch.int32, device=dev)
    with profile_trace(str(tmp_path)) as prof:
        for _ in range(3):
            gem_l2n_fused_rect(x, 3.0, sizes)
        gem_l2n_fused(x, 3.0)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type != cuda]  # host-side ranges
    assert names.count("gem_l2n_fused_rect") == 3 and names.count("gem_l2n_fused") == 1
    kernels = [e for e in prof.events() if e.device_type == cuda and "gem_l2n_kernel" in e.name
               and not e.is_user_annotation]
    assert len(kernels) == 4
    with debug_checks():
        assert_deterministic(gem_l2n_fused_rect, x, 3.0, sizes)
    # the kernel writes inf / inf for an infinite map; its output is checked
    # at the first operator that reads it
    inf = torch.full_like(x, float("inf"))
    with pytest.raises(FloatingPointError):
        with debug_checks():
            gem_l2n_fused(inf, 3.0).sum()


def _grads_close(got, want, rel=1e-5, atol=0.0):
    """Each gradient within ``rel`` of its reference's max|g| (or ``atol``)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max().item()
        assert err <= max(rel * w.float().abs().max().item(), atol), err


@pytest.mark.parametrize("entry", ["fused", "rect"])
def test_gem_function_gradients_match_autograd_through_plain(dev, entry):
    """The GeM head's Function on the card at the head's full width (16
    images, 32 x 32 map, C = 2048, ragged extents): the kernel forward, and
    dfeats and dp against autograd through ``gem_l2n_plain`` (1e-5 of
    max|g|; dp, one sum over B x C terms, also 1e-7 absolute)."""
    x = _rand((16, 32, 32, 2048), 11, dev) + 0.05
    sizes = torch.randint(1, 33, (16, 2), generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32).to(dev)
    g = torch.randn((16, 2048), generator=torch.Generator().manual_seed(2)).to(dev)
    runs = []
    for use_kernel in (True, False):
        f = x.clone().requires_grad_()
        p = torch.nn.Parameter(torch.tensor([3.0], device=dev))
        s = sizes if entry == "rect" else None
        if use_kernel:
            before = (gem_l2n_fused if s is None else gem_l2n_fused_rect).launches
            out = gem_l2n_fused(f, p) if s is None else gem_l2n_fused_rect(f, p, s)
            assert type(out.grad_fn).__name__ == "_GemL2NBackward"
            assert (gem_l2n_fused if s is None else gem_l2n_fused_rect).launches == before + 1
        else:
            out = gem_l2n_plain(f, p, s)
        out.backward(g)
        runs.append((out.detach(), f.grad, p.grad))
    (ok, fk, pk), (op, fp, pp) = runs
    torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
    _grads_close([fk], [fp])
    _grads_close([pk], [pp], atol=1e-7)


def test_gem_p_gradient_with_a_frozen_trunk(dev):
    """Features that need no gradient and a trainable p: the kernel's output
    hangs on the Function and p gets the plain version's gradient (before
    the Function existed the kernel's output had no graph and p got none)."""
    x = _rand((4, 8, 8, 2048), 12, dev) + 0.05
    sizes = torch.tensor([[8, 8], [5, 8], [8, 3], [1, 1]], dtype=torch.int32, device=dev)
    g = torch.randn((4, 2048), generator=torch.Generator().manual_seed(3)).to(dev)
    grads = []
    for fn in (gem_l2n_fused_rect, gem_l2n_plain):
        p = torch.nn.Parameter(torch.tensor([3.0], device=dev))
        fn(x, p, sizes).backward(g)
        grads.append(p.grad)
    assert grads[0] is not None and grads[0].abs().item() > 0
    _grads_close([grads[0]], [grads[1]], atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 37, 128])
def test_fused_topk_matches_plain_with_duplicates(dev, dtype, k):
    g = torch.Generator().manual_seed(2)
    base = torch.randn((700, 96), generator=g)
    gallery = torch.cat([base, base[::7]], 0)[torch.randperm(800, generator=g)]
    gallery = gallery.to(dev).to(dtype).contiguous()
    q = torch.randn((45, 96), generator=g).to(dev)
    s, i = fused_topk_search(gallery, q, k)
    ps, pi = fused_topk_plain(gallery, q, k)
    torch.testing.assert_close(s, ps, rtol=0, atol=1e-5)
    # indices agree wherever the plain scores are separated from their neighbours
    gap = torch.cat([ps[:, :-1] - ps[:, 1:], torch.full_like(ps[:, :1], 1.0)], 1)
    clear = (gap > 1e-5) & torch.cat([torch.ones_like(gap[:, :1], dtype=torch.bool),
                                      gap[:, :-1] > 1e-5], 1)
    assert torch.equal(i[clear], pi[clear])


def test_fused_topk_exact_ties_lower_index_first(dev):
    gallery = torch.zeros((300, 32), device=dev)
    gallery[:, 0] = 1.0  # every score ties
    q = torch.ones((3, 32), device=dev)
    _, i = fused_topk_search(gallery, q, 100)
    assert torch.equal(i, torch.arange(100, device=dev, dtype=torch.int32).expand(3, -1))


def _netvlad_inputs(dev, B, H, W, C, K, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((B, H, W, C), generator=g))
    # image 0 lies along one direction: most clusters get exactly zero mass
    x[0] = 100.0 * torch.randn(C, generator=g).abs() + 0.1 * x[0]
    c = torch.randn((K, C), generator=g)
    w = torch.randn((C, K), generator=g) / C ** 0.5
    b = 0.1 * torch.randn(K, generator=g)
    return [t.to(dev).contiguous() for t in (x, c, w, b)]


@pytest.mark.parametrize("C", [96, 100, 37])
@pytest.mark.parametrize("K", [8, 64, 100, 129, 256])
def test_netvlad_kernels_match_plain(dev, K, C):
    """Any K (cluster tiles of 64, ragged at 100, 129) and any C (100 and 37
    are padded to 128 and 64 channels by the wrapper): within 1e-5 of plain,
    (0, 0) rows zero, zero-mass clusters zero in plain's pattern, the same
    bits on a second call."""
    B, H, W = 5, 9, 13  # N = 117 is not a multiple of the kernel's tiles
    x, c, w, b = _netvlad_inputs(dev, B, H, W, C, K, K + C)
    sizes = torch.tensor([[9, 13], [0, 0], [4, 13], [9, 5], [1, 1]], dtype=torch.int32,
                         device=dev)
    got = netvlad_fused_rect(x, c, w, b, sizes=sizes)
    want = netvlad_plain(x, c, w, b, sizes)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.all(got[1] == 0)
    rows = got[0].reshape(K, C)
    zero = torch.all(rows == 0, dim=1)
    assert torch.equal(zero, torch.all(want[0].reshape(K, C) == 0, dim=1))
    if K > 8:
        assert 0 < int(zero.sum()) < K
    assert torch.equal(got, netvlad_fused_rect(x, c, w, b, sizes=sizes))
    torch.testing.assert_close(netvlad_fused(x, c, w, None), netvlad_plain(x, c, w, None),
                               rtol=0, atol=1e-5)
    # [B, N, C] input and a deterministic second run
    x3 = x.reshape(B, H * W, C)
    assert torch.equal(netvlad_fused(x3, c, w, b), netvlad_fused(x3, c, w, b))


@pytest.mark.parametrize("K", [64, 200])
def test_netvlad_kernels_span_row_chunks(dev, K):
    """Images whose valid rows span several 512-row chunks of the
    aggregation (2,400 rows, and 1,537 in a ragged rectangle: one row past
    three chunks), one with a single valid row, a one-column rectangle and
    an empty one."""
    B, H, W, C = 5, 40, 60, 64
    x, c, w, b = _netvlad_inputs(dev, B, H, W, C, K, 7)
    sizes = torch.tensor([[40, 60], [1, 1], [29, 53], [0, 0], [40, 1]], dtype=torch.int32,
                         device=dev)
    got = netvlad_fused_rect(x, c, w, b, sizes=sizes)
    torch.testing.assert_close(got, netvlad_plain(x, c, w, b, sizes), rtol=0, atol=1e-5)
    assert torch.all(got[3] == 0)
    assert torch.equal(got, netvlad_fused_rect(x, c, w, b, sizes=sizes))
    got = netvlad_fused(x, c, w, b)
    torch.testing.assert_close(got, netvlad_plain(x, c, w, b), rtol=0, atol=1e-5)
    assert torch.equal(got, netvlad_fused(x, c, w, b))


@pytest.mark.parametrize("K,C", [(64, 512), (129, 96), (256, 37)])
def test_netvlad_split_planes_are_split_tf32(dev, K, C):
    """The planes of W^T that netvlad_forward's first kernel writes are
    bit for bit ``split_tf32`` of W^T zero-padded to [KP, Cp] (the rule the
    CPU tests hold against the Pallas kernels), and the entry called
    directly gives the wrapper's result."""
    import torch.nn.functional as F

    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bottleneck import (
        split_tf32,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.netvlad import (
        _plan,
        prepare_operands,
    )

    x, c, w, b = _netvlad_inputs(dev, 2, 3, 5, C, K, 5)
    x3 = x.reshape(2, 15, C)
    xp, cen, wp = prepare_operands(x3, c, w)
    cp = xp.shape[-1]
    plan = _plan(2, 15, cp, K)
    scratch = {n: torch.empty(shape, device=dev) for n, shape in plan["scratch"].items()}
    out = torch.empty((2, K * cp), device=dev)
    err = _build.load("netvlad").netvlad_forward(
        xp.data_ptr(), wp.data_ptr(), b.data_ptr(), cen.data_ptr(), None,
        *(t.data_ptr() for t in scratch.values()), out.data_ptr(), 2, 15, 1, cp, K,
        plan["n_chunks"], torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    hi, lo = split_tf32(F.pad(wp.t(), (0, 0, 0, -(-K // 64) * 64 - K)))
    assert torch.equal(scratch["wt_hi"], hi) and torch.equal(scratch["wt_lo"], lo)
    assert torch.equal(out.view(2, K, cp)[:, :, :C].reshape(2, K * C),
                       netvlad_fused(x3, c, w, b))


@pytest.mark.parametrize("entry", ["fused", "rect"])
def test_netvlad_function_gradients_match_autograd_through_the_oracle(dev, entry):
    """The NetVLAD head's Function on the card at config 3's head width (4
    images, 32 x 32 map, C = 512, K = 64, ragged extents): the kernel
    forward, and the gradients of x, centroids, assign_w and assign_b
    against autograd through ``netvlad_aggregate`` (the oracle the JAX VJP
    differentiates) within 1e-5 of max|g| (assign_b, a sum over B x N
    positions, also 1e-6 absolute)."""
    from image_retrieval_for_image_based_localization_tpu_torch.ops.netvlad import (
        netvlad_aggregate,
    )

    x, c, w, b = _netvlad_inputs(dev, 4, 32, 32, 512, 64, 13)
    sizes = torch.tensor([[32, 32], [20, 32], [32, 7], [1, 1]], dtype=torch.int32, device=dev)
    mask = ((torch.arange(32, device=dev)[:, None] < sizes[:, 0, None, None])
            & (torch.arange(32, device=dev) < sizes[:, 1, None, None]))
    g = torch.randn((4, 64 * 512), generator=torch.Generator().manual_seed(4)).to(dev)
    runs = []
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, c, w, b)]
        if use_kernel:
            out = (netvlad_fused(*leaves) if entry == "fused"
                   else netvlad_fused_rect(*leaves, sizes=sizes))
            assert type(out.grad_fn).__name__ == "_NetVLADBackward"
        else:
            out = netvlad_aggregate(*leaves, mask=None if entry == "fused" else mask)
        out.backward(g)
        runs.append((out.detach(), [t.grad for t in leaves]))
    (ok, gk), (op, gp) = runs
    torch.testing.assert_close(ok, op, rtol=0, atol=1e-5)
    _grads_close(gk[:3], gp[:3])
    _grads_close(gk[3:], gp[3:], atol=1e-6)


def test_netvlad_kernel_runs_large_k(dev):
    """K past the old 128-cluster limit runs and matches plain."""
    x, c, w, b = _netvlad_inputs(dev, 2, 3, 5, 8, 129, 1)
    torch.testing.assert_close(netvlad_fused(x, c, w, b), netvlad_plain(x, c, w, b),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scores_blockmax_matches_plain(dev, dtype):
    g = torch.Generator().manual_seed(3)
    gallery = torch.randn((1000, 200), generator=g).to(dev).to(dtype)  # 1000 = 15.6 blocks
    q = torch.randn((70, 200), generator=g).to(dev)
    s, bmax = scores_blockmax(gallery, q)
    ps, pb = scores_blockmax_plain(gallery, q)
    assert s.shape == (70, 1024) and bmax.shape == (70, 16)
    torch.testing.assert_close(s, ps, rtol=0, atol=1e-4)
    assert torch.all(s[:, 1000:] == NEG_INF)
    assert torch.equal(bmax, s.view(70, 16, 64).amax(-1))
    torch.testing.assert_close(bmax, pb, rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [37, 200, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_shortlist_search_exact_with_duplicates(dev, dtype, k):
    g = torch.Generator().manual_seed(4)
    base = torch.randn((900, 64), generator=g)
    gallery = torch.cat([base, base[::5], base[::7]], 0)
    gallery = gallery[torch.randperm(gallery.shape[0], generator=g)]
    gallery = gallery.to(dev).to(dtype).contiguous()
    q = torch.randn((33, 64), generator=g).to(dev)
    scores = score_matrix(gallery, q)
    want = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    s, i = knn_search(gallery, q, k, chunk=512)  # three chunks, carried merge
    # every score is one fmaf chain, so duplicate rows tie bit for bit: the
    # order is exact wherever the dense product's scores are separated
    gap = torch.cat([s[:, :-1] - s[:, 1:], torch.ones_like(s[:, :1])], 1)
    clear = (gap > 1e-4) & torch.cat([torch.ones_like(gap[:, :1], dtype=torch.bool),
                                      gap[:, :-1] > 1e-4], 1)
    assert torch.equal(i.long()[clear], want[clear])
    ordered = (s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))
    assert bool(ordered.all())
    s1, i1 = blockmax_topk_search(gallery, q.to(dtype).float(), k)
    assert torch.equal(i1, i) and torch.equal(s1, s)  # one chunk or three: the same list


@pytest.mark.parametrize("m", [8, 16, 64, 256])
@pytest.mark.parametrize("nq", [1, 3, 5, 33])
def test_adc_scores_match_plain_bitwise(dev, nq, m):
    """Kernel and plain version add the subquantizers in the same order:
    equal bits, with nq not a multiple of the queries a block, several LUT
    slices (M >= 64) and the byte-load path (M = 8)."""
    n = 700 if m < 256 else 300
    g = torch.Generator().manual_seed(5)
    lut = torch.randn((nq, m, 256), generator=g).to(dev)
    codes = torch.randint(0, 256, (n, m), generator=g, dtype=torch.uint8)
    codes[n // 2 :: 9] = codes[1]  # duplicate rows tie bit for bit
    codes = codes.to(dev)
    dup = torch.nonzero((codes == codes[1]).all(1)).flatten()
    for n_valid in (n, n - 17):
        s, bmax = adc_scores(lut, codes, n_valid=n_valid)
        ps, pb = adc_scores_plain(lut, codes, n_valid=n_valid)
        assert torch.equal(s, ps) and torch.equal(bmax, pb)
        assert torch.all(s[:, n_valid:] == NEG_INF)
        live = dup[dup < n_valid]
        assert len(live) > 2 and torch.all(s[:, live] == s[:, live[:1]])


def test_adc_scores_past_the_grid_limit(dev):
    """More than 65,535 row tiles of 2,048 (134M rows): the entry launches
    again for the tiles past grid.y's limit, and every row still scores bit
    for bit."""
    nq, m = 5, 8
    n = 65_535 * 2048 + 3 * 2048 + 37
    g = torch.Generator(device=dev).manual_seed(7)
    lut = torch.randn((nq, m, 256), generator=g, device=dev)
    codes = torch.randint(0, 256, (n, m), generator=g, device=dev, dtype=torch.uint8)
    s, bmax = adc_scores(lut, codes)
    ps, pb = adc_scores_plain(lut, codes)
    assert torch.equal(s, ps) and torch.equal(bmax, pb)


def test_adc_topk_core_ties_lower_row_first(dev):
    lut = torch.randn((4, 64, 256), generator=torch.Generator().manual_seed(6)).to(dev)
    codes = torch.full((3000, 64), 17, dtype=torch.uint8, device=dev)
    s, i = adc_topk_core(lut, codes, k=200, chunk=1024)
    assert torch.equal(i, torch.arange(200, device=dev, dtype=torch.int32).expand(4, -1))


# the last five: B H W not a multiple of 128, H = W = 1, Cin = Cm = 32, a
# tile spanning distinct small images (a 3x3 tap leaking across an image
# border shows), and column tiles that do not divide N (Cm = 96, Cin = 160)
@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 32), (1, 23, 13, 256, 64),
                                   (1, 9, 7, 2048, 512), (2, 33, 40, 512, 128),
                                   (3, 11, 9, 256, 64), (5, 1, 1, 256, 64), (2, 12, 10, 32, 32),
                                   (3, 5, 7, 128, 32), (2, 6, 9, 160, 96)])
def test_bottleneck_matches_plain(dev, shape):
    B, H, W, cin, cm = shape
    g = torch.Generator().manual_seed(7)
    x = torch.relu(torch.randn((B, H, W, cin), generator=g))
    w1 = torch.randn((cin, cm), generator=g) * (2 / cin) ** 0.5
    w2 = torch.randn((3, 3, cm, cm), generator=g) * (2 / (9 * cm)) ** 0.5
    w3 = torch.randn((cm, cin), generator=g) * (2 / cm) ** 0.5
    b1, b2, b3 = (0.1 * torch.randn(c, generator=g) for c in (cm, cm, cin))
    args = [t.to(dev).contiguous() for t in (x, w1, b1, w2, b2, w3, b3)]
    got = bottleneck_fused(*args)
    want = bottleneck_plain(*args)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_bottleneck_refuses_grad_and_odd_channels(dev):
    x = torch.zeros((1, 4, 4, 64), device=dev, requires_grad=True)
    w = [torch.zeros(s, device=dev) for s in ((64, 32), (32,), (3, 3, 32, 32), (32,),
                                               (32, 64), (64,))]
    with pytest.raises(RuntimeError, match="inference-only"):
        bottleneck_fused(x, *w)
    w = [torch.zeros(s, device=dev) for s in ((64, 20), (20,), (3, 3, 20, 20), (20,),
                                               (20, 64), (64,))]
    with pytest.raises(ValueError, match="multiples of 32"):
        bottleneck_fused(x.detach(), *w)


BF16_NOT_EQUAL_SHARE = 0.05  # chip_smoke.py's gate; sound runs read at most 0.95 %


def _bottleneck_bf16_args(dev, shape, seed=8):
    B, H, W, cin, cm = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn((B, H, W, cin), generator=g)).to(torch.bfloat16)
    w1 = torch.randn((cin, cm), generator=g) * (2 / cin) ** 0.5
    w2 = torch.randn((3, 3, cm, cm), generator=g) * (2 / (9 * cm)) ** 0.5
    w3 = torch.randn((cm, cin), generator=g) * (2 / cm) ** 0.5
    b1, b2, b3 = (0.1 * torch.randn(c, generator=g) for c in (cm, cm, cin))
    return [t.to(dev).contiguous() for t in (x, w1, b1, w2, b2, w3, b3)]


def _bottleneck_bf16_route(dev, shape):
    """The bf16 kernel and the plain version on one block: (got, want), the
    kernel called twice (weights packed per call, then once) with the same
    bits."""
    args = _bottleneck_bf16_args(dev, shape)
    got = bottleneck_fused(*args)
    again = bottleneck_fused(*args, packed=pack_bf16(args[1], args[3], args[5]))
    want = bottleneck_plain(*args)
    assert got.dtype == want.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, again)  # packed once or per call, the same bits
    assert (got != want).float().mean().item() <= BF16_NOT_EQUAL_SHARE
    return got.float(), want.float()


# the bf16 form against the plain version at its rounding points (the JAX
# kernel's), within 2^-8 of max|plain|, and at most BF16_NOT_EQUAL_SHARE of
# the values not bit-equal (a rounding other than to nearest even flips tens
# of percent); the second shape's 128-pixel tiles span 35-pixel images, the
# third's column tiles do not divide N (Cm = 96: 32-deep stages)
@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 32), (3, 5, 7, 256, 64),
                                   (2, 6, 9, 160, 96)])
def test_bottleneck_bf16_matches_plain(dev, shape):
    got, want = _bottleneck_bf16_route(dev, shape)
    assert (got - want).abs().max().item() <= 2.0 ** -8 * want.abs().max().item()


# the kernel's other routes, under chip_smoke.py's gate (one bf16 ulp at
# max|plain|, at most BF16_NOT_EQUAL_SHARE not bit-equal, a second call bit
# for bit): at these sizes a rounding flipped by f32 sums in another order
# can fall in max|plain|'s binade, one ulp there being 2^-8 to 2^-7 of it.
# Cm = 64 (256 x 64 tiles, 64 deep), Cm = 128 at Cin = 512 (128 x 128
# tiles), Cin = 160 (32 deep, a ragged 128-wide column tile), M below one tile
@pytest.mark.parametrize("shape", [(2, 12, 10, 256, 64), (2, 33, 40, 512, 128),
                                   (2, 9, 7, 160, 64), (1, 5, 7, 256, 64)])
def test_bottleneck_bf16_routes_match_plain(dev, shape):
    got, want = _bottleneck_bf16_route(dev, shape)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2.0 ** (math.floor(math.log2(top)) - 7)


# the kernel's shared-memory attribute belongs to each device's context: a
# process that runs the bf16 form on one card and then on another launches
# on both, with the same bits
def test_bottleneck_bf16_runs_on_a_second_device():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    shape = (2, 12, 10, 256, 64)
    got0, want0 = _bottleneck_bf16_route(resolve_device("cuda:0"), shape)
    got1, want1 = _bottleneck_bf16_route(resolve_device("cuda:1"), shape)
    assert torch.equal(got0.cpu(), got1.cpu()) and torch.equal(want0.cpu(), want1.cpu())


# the f32 kernels that data-parallel extraction and training launch (B1, B2,
# B5, B6, B8), each on cuda:0 and then on cuda:1 in one process: a launch on
# each card, within its bound of the plain version there, the same bits on
# both cards
SECOND_DEVICE_KERNELS = ["gem_l2n_fused_rect", "gem_l2n_fused", "netvlad_fused_rect",
                         "netvlad_fused", "bottleneck_fused"]


def _second_device_case(name, dev):
    """(kernel output, plain output, max|err| bound) of one seeded call."""
    if name.startswith("gem"):
        x = _rand((7, 5, 7, 2048), 0, dev)
        p = torch.tensor([3.0], device=dev)
        if name == "gem_l2n_fused":
            return gem_l2n_fused(x, p), gem_l2n_plain(x, p), 1e-5
        sizes = torch.tensor([[5, 7], [0, 0], [3, 2], [1, 7], [5, 1], [2, 6], [1, 1]],
                             dtype=torch.int32, device=dev)
        return gem_l2n_fused_rect(x, p, sizes), gem_l2n_plain(x, p, sizes), 1e-5
    if name.startswith("netvlad"):
        x, c, w, b = _netvlad_inputs(dev, 5, 9, 13, 96, 64, 3)
        if name == "netvlad_fused":
            return netvlad_fused(x, c, w, b), netvlad_plain(x, c, w, b, None), 1e-5
        sizes = torch.tensor([[9, 13], [0, 0], [4, 13], [9, 5], [1, 1]], dtype=torch.int32,
                             device=dev)
        return netvlad_fused_rect(x, c, w, b, sizes=sizes), netvlad_plain(x, c, w, b, sizes), \
            1e-5
    g = torch.Generator().manual_seed(7)
    B, H, W, cin, cm = 2, 16, 16, 256, 64
    x = torch.relu(torch.randn((B, H, W, cin), generator=g))
    w1 = torch.randn((cin, cm), generator=g) * (2 / cin) ** 0.5
    w2 = torch.randn((3, 3, cm, cm), generator=g) * (2 / (9 * cm)) ** 0.5
    w3 = torch.randn((cm, cin), generator=g) * (2 / cm) ** 0.5
    b1, b2, b3 = (0.1 * torch.randn(c, generator=g) for c in (cm, cm, cin))
    args = [t.to(dev).contiguous() for t in (x, w1, b1, w2, b2, w3, b3)]
    want = bottleneck_plain(*args)
    return bottleneck_fused(*args), want, 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("name", SECOND_DEVICE_KERNELS)
def test_f32_kernels_run_on_a_second_device(name):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels

    fn = getattr(kernels, name)
    outs = []
    for i in (0, 1):
        dev = resolve_device(f"cuda:{i}")
        before = fn.launches
        got, want, bound = _second_device_case(name, dev)
        torch.cuda.synchronize(dev)
        assert fn.launches == before + 1 and got.device == dev
        assert (got - want).abs().max().item() <= bound
        outs.append(got.cpu())
    assert torch.equal(outs[0], outs[1])


def test_bottleneck_bf16_launches_its_kernel_and_never_the_plain_version(dev, monkeypatch):
    from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
        bottleneck as mod,
    )

    def refuse(*a, **k):
        raise AssertionError("a bf16 CUDA call reached the plain version")

    args = _bottleneck_bf16_args(dev, (1, 4, 4, 64, 32))
    monkeypatch.setattr(mod, "bottleneck_plain", refuse)
    before, before_bf16 = bottleneck_fused.launches, bottleneck_fused_bf16.launches
    out = bottleneck_fused(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (bottleneck_fused.launches - before, bottleneck_fused_bf16.launches - before_bf16) \
        == (0, 1)
    assert torch.equal(bottleneck_fused(*args), out)  # a second call, the same bits
    assert bottleneck_fused_bf16.launches - before_bf16 == 2
    bad = pack_bf16(args[1], args[3], args[5])._replace(w3t=args[5].to(torch.bfloat16))
    with pytest.raises(ValueError, match="packed.w3t"):
        bottleneck_fused(*args, packed=bad)


# Ragged and unaligned shapes of the two exact-search kernels, which share
# the mainloop of csrc/sgemm_tile.cuh: (Nq, Ng, D, gallery layout). "offset"
# starts the gallery 4 bytes into its buffer, so it is not 16-byte aligned
# and the scalar-load variant runs even where D is a multiple of the vector.
SEARCH_SHAPES = [(1, 100_003, 37, "rows"), (20, 63, 2048, "rows"), (257, 65, 100, "rows"),
                 (257, 1, 4096, "rows"), (20, 100_003, 100, "rows"), (1, 65, 2048, "rows"),
                 (257, 1000, 2048, "offset"), (20, 777, 37, "slice")]


def _search_inputs(dev, dtype, nq, ng, d, layout, seed=11):
    """Unit-norm rows (scores in [-1, 1]) with row 0 planted again at the
    end; ``slice`` takes rows 1.. of a larger gallery, ``offset`` starts the
    gallery one element into a flat buffer."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.nn.functional.normalize(torch.randn((ng + 1, d), generator=gen), dim=1)
    if ng > 2:
        g[-1] = g[1]
    q = torch.nn.functional.normalize(torch.randn((nq, d), generator=gen), dim=1).to(dev)
    g = g.to(dev).to(dtype)
    if layout == "slice":
        gallery = g[1:]
    elif layout == "offset":
        flat = torch.empty(ng * d + 1, dtype=dtype, device=dev)
        gallery = flat[1:].view(ng, d)
        gallery.copy_(g[1:])
    else:
        gallery = g[1:].clone()
    assert gallery.is_contiguous()
    aligned = gallery.data_ptr() % 16 == 0
    assert aligned == (layout != "offset") or layout == "slice"
    return gallery, q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SEARCH_SHAPES)
def test_scores_blockmax_ragged_and_unaligned(dev, dtype, shape):
    gallery, q = _search_inputs(dev, dtype, *shape)
    nq, ng = q.shape[0], gallery.shape[0]
    nb = -(-ng // 64)
    s, bmax = scores_blockmax(gallery, q)
    ps, pb = scores_blockmax_plain(gallery, q)
    assert s.shape == (nq, nb * 64) and bmax.shape == (nq, nb)
    torch.testing.assert_close(s[:, :ng], ps[:, :ng], rtol=0, atol=1e-5)
    assert torch.all(s[:, ng:] == NEG_INF)
    assert torch.equal(bmax, s.view(nq, nb, 64).amax(-1))
    torch.testing.assert_close(bmax, pb, rtol=0, atol=1e-5)
    if ng > 2:  # the planted duplicate (rows 0 and ng - 1) scores bit for bit
        assert torch.equal(s[:, 0], s[:, ng - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SEARCH_SHAPES)
def test_fused_topk_ragged_and_unaligned(dev, dtype, shape):
    gallery, q = _search_inputs(dev, dtype, *shape)
    for k in (1, 100, 128):
        s, i = fused_topk_search(gallery, q, k)
        ps, pi = fused_topk_plain(gallery, q, k)
        kk = min(k, gallery.shape[0])
        assert s.shape == (q.shape[0], kk) and i.shape == (q.shape[0], kk)
        torch.testing.assert_close(s, ps, rtol=0, atol=1e-5)
        gap = torch.cat([ps[:, :-1] - ps[:, 1:], torch.full_like(ps[:, :1], 1.0)], 1)
        clear = (gap > 1e-5) & torch.cat([torch.ones_like(gap[:, :1], dtype=torch.bool),
                                          gap[:, :-1] > 1e-5], 1)
        assert torch.equal(i[clear], pi[clear])
        ordered = (s[:, :-1] > s[:, 1:]) | ((s[:, :-1] == s[:, 1:]) & (i[:, :-1] < i[:, 1:]))
        assert bool(ordered.all())
        assert int(i.min()) >= 0 and int(i.max()) < gallery.shape[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2048, 100])
def test_exact_search_kernels_agree_bit_for_bit(dev, dtype, d):
    """Both kernels run one mainloop: every score fused_topk returns equals
    scores_blockmax's at the same (query, row) bit for bit, and duplicate
    rows tie exactly."""
    gallery, q = _search_inputs(dev, dtype, 70, 5000, d, "rows")
    s, i = fused_topk_search(gallery, q, 128)
    full, _ = scores_blockmax(gallery, q.to(dtype).float())
    assert torch.equal(s, torch.gather(full, 1, i.long()))
    assert torch.equal(full[:, 0], full[:, gallery.shape[0] - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_search_kernels_deterministic(dev, dtype):
    gallery, q = _search_inputs(dev, dtype, 257, 20_000, 100, "slice")
    a = fused_topk_search(gallery, q, 100)
    b = fused_topk_search(gallery, q, 100)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a = scores_blockmax(gallery, q)
    b = scores_blockmax(gallery, q)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
