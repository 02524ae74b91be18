"""The differentiable head kernels: the port's GeM + L2N and NetVLAD autograd
Functions (what the wrappers take when an input needs a gradient; on CPU
tensors their forward is the plain version) against ``jax.vjp`` through the
JAX package's Pallas kernels in interpret mode, whose custom VJPs
differentiate the JAX oracles.

Tolerance: every gradient within 1e-5 of its tensor's max|g| (f32 sums in
another order); GeM's ``dp``, one scalar summed over B x C terms that
cancel, within 1e-5 relative or 1e-7 absolute; NetVLAD's ``dassign_b``, a
sum over B x N positions that cancels across clusters, within 1e-5 relative
or 1e-6 absolute (with saturated assignments each package lies ~1.5e-7 from
a float64 VJP); a bf16 input's gradient
comes back in bf16 and is held to one bf16 rounding (2^-8 of max|g|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irtpu.ops.pallas import gem_l2n_fused as j_gem
from irtpu.ops.pallas import gem_l2n_fused_rect as j_gem_rect
from irtpu.ops.pallas import netvlad_fused as j_nv
from irtpu.ops.pallas import netvlad_fused_rect as j_nv_rect

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import (
    gem_l2n_fused,
    gem_l2n_fused_rect,
    netvlad_fused,
    netvlad_fused_rect,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

REL = 1e-5
DP_ATOL = 1e-7
DB_ATOL = 1e-6
NV_GRADS = ("dx", "dcentroids", "dassign_w", "dassign_b")
BF16_REL = 2.0 ** -8
SIZES = np.array([[5, 7], [3, 2], [1, 7]], np.int32)  # full, ragged, one row


def assert_grad_close(got, want, rel=REL, name="", atol=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= max(rel * scale, atol), \
        f"{name}: max|err| {err:.3e} > {rel} x max|g| {scale:.3e} (atol {atol})"
    assert np.abs(want).max() > 0, f"{name}: zero reference gradient"


def _gem_inputs(seed, shape=(3, 5, 7, 24)):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(*shape)).astype(np.float32) + 0.05
    g = rng.randn(shape[0], shape[-1]).astype(np.float32)
    return x, g


@pytest.mark.parametrize("entry", ["fused", "rect"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gem_function_grads_match_jax_vjp(entry, dtype):
    x, g = _gem_inputs(1)
    feats = torch.from_numpy(x)
    if dtype == "bfloat16":
        feats = feats.to(torch.bfloat16)
    jx = jnp.asarray(feats.float().numpy(), jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    feats.requires_grad_()
    p = torch.nn.Parameter(torch.tensor([2.7]))
    if entry == "fused":
        out = gem_l2n_fused(feats, p)
        f = lambda xx, pp: j_gem(xx, pp, chunk=8, interpret=True)  # noqa: E731
    else:
        out = gem_l2n_fused_rect(feats, p, torch.from_numpy(SIZES))
        f = lambda xx, pp: j_gem_rect(xx, pp, jnp.asarray(SIZES), chunk=16,  # noqa: E731
                                      interpret=True)
    assert type(out.grad_fn).__name__ == "_GemL2NBackward"
    out.backward(torch.from_numpy(g))
    want_out, vjp = jax.vjp(f, jx, jnp.float32(2.7))
    dx, dp = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-6)
    assert feats.grad.dtype == feats.dtype and p.grad.shape == (1,)
    rel = BF16_REL if dtype == "bfloat16" else REL
    assert_grad_close(feats.grad.float().numpy(), np.asarray(dx, np.float32), rel, "dfeats")
    assert_grad_close(p.grad.numpy(), np.asarray(dp).reshape(1), REL, "dp", DP_ATOL)
    if entry == "rect":  # invalid positions of the rectangle get no gradient
        assert torch.all(feats.grad[1, 3:] == 0) and torch.all(feats.grad[2, 1:] == 0)


def test_gem_p_gets_its_gradient_with_a_frozen_trunk():
    """The features need no gradient, p does: the call still goes through
    the Function and p's gradient is the JAX package's dp."""
    x, g = _gem_inputs(2)
    p = torch.nn.Parameter(torch.tensor([3.0]))
    out = gem_l2n_fused_rect(torch.from_numpy(x), p, torch.from_numpy(SIZES))
    assert type(out.grad_fn).__name__ == "_GemL2NBackward"
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda pp: j_gem_rect(jnp.asarray(x), pp, jnp.asarray(SIZES), chunk=16,
                                           interpret=True), jnp.float32(3.0))
    (dp,) = vjp(jnp.asarray(g))
    assert p.grad is not None and float(p.grad.abs()) > 0
    assert_grad_close(p.grad.numpy(), np.asarray(dp).reshape(1), REL, "dp", DP_ATOL)


def test_gem_wrappers_take_the_function_only_when_a_gradient_is_needed():
    x, _ = _gem_inputs(3)
    feats, sizes = torch.from_numpy(x), torch.from_numpy(SIZES)
    assert gem_l2n_fused(feats, 3.0).grad_fn is None
    assert gem_l2n_fused_rect(feats, torch.tensor([3.0]), sizes).grad_fn is None
    p = torch.nn.Parameter(torch.tensor([3.0]))
    with torch.no_grad():
        assert gem_l2n_fused(feats.requires_grad_(), p).grad_fn is None
    assert type(gem_l2n_fused(feats, 3.0).grad_fn).__name__ == "_GemL2NBackward"


def _nv_inputs(seed, B=3, H=5, W=7, C=32, K=8):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(B, H, W, C)).astype(np.float32)
    c = rng.randn(K, C).astype(np.float32)
    w = (rng.randn(C, K) / np.sqrt(C)).astype(np.float32)
    b = (0.1 * rng.randn(K)).astype(np.float32)
    g = rng.randn(B, K * C).astype(np.float32)
    return x, c, w, b, g


@pytest.mark.parametrize("entry", ["fused", "rect"])
def test_netvlad_function_grads_match_jax_vjp(entry):
    x, c, w, b, g = _nv_inputs(4)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, c, w, b)]
    if entry == "fused":
        out = netvlad_fused(*ts)
        f = lambda *a: j_nv(*a, chunk=32, interpret=True)  # noqa: E731
    else:
        out = netvlad_fused_rect(*ts, sizes=torch.from_numpy(SIZES))
        f = lambda *a: j_nv_rect(*a, sizes=jnp.asarray(SIZES), chunk=32,  # noqa: E731
                                 interpret=True)
    assert type(out.grad_fn).__name__ == "_NetVLADBackward"
    out.backward(torch.from_numpy(g))
    want_out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, c, w, b)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-5)
    for name, t, want in zip(NV_GRADS, ts, vjp(jnp.asarray(g))):
        assert_grad_close(t.grad.numpy(), want, REL, name, DB_ATOL if name == "dassign_b" else 0)


def test_netvlad_zero_mass_clusters_give_finite_gradients():
    """Logits far apart, as the k-means init's alpha = 100 makes them, leave
    whole clusters with exactly zero soft mass: their rows are exactly zero,
    and the gradient stays finite and equal to the JAX VJP's."""
    x, c, w, b, g = _nv_inputs(5)
    b = np.where(np.arange(8) < 3, 0.0, -300.0).astype(np.float32)  # exp(-300) = 0 in f32
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, c, w, b)]
    out = netvlad_fused(*ts)
    rows = out.detach().numpy().reshape(3, 8, 32)
    assert np.any(np.all(rows == 0.0, axis=2))
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: j_nv(*a, chunk=32, interpret=True),
                     *(jnp.asarray(a) for a in (x, c, w, b)))
    for name, t, want in zip(NV_GRADS, ts, vjp(jnp.asarray(g))):
        assert np.isfinite(t.grad.numpy()).all(), name
        assert_grad_close(t.grad.numpy(), want, REL, name, DB_ATOL if name == "dassign_b" else 0)


def test_netvlad_function_with_no_bias_and_one_parameter_needing_grad():
    x, c, w, _, g = _nv_inputs(6)
    cen = torch.nn.Parameter(torch.from_numpy(c))
    out = netvlad_fused_rect(torch.from_numpy(x), cen, torch.from_numpy(w), None,
                             sizes=torch.from_numpy(SIZES))
    assert type(out.grad_fn).__name__ == "_NetVLADBackward"
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda cc: j_nv_rect(jnp.asarray(x), cc, jnp.asarray(w), None,
                                          sizes=jnp.asarray(SIZES), chunk=32, interpret=True),
                     jnp.asarray(c))
    assert_grad_close(cen.grad.numpy(), vjp(jnp.asarray(g))[0], REL, "dcentroids")
    with torch.no_grad():
        assert netvlad_fused(torch.from_numpy(x), cen, torch.from_numpy(w)).grad_fn is None
