"""Fused GeM pooling + L2 normalization: CUDA kernel and its plain version.

Replaces the JAX package's ``ops/pallas/gem_l2n.py::gem_l2n_fused`` and
``gem_l2n_fused_rect``. The kernel is ``csrc/gem_l2n.cu``: bound by the bytes
of one read of the feature map, it runs the whole function in one launch, a
thread-block cluster of eight CTAs per image that sum ``clamp(x, 1e-6)^p``
over equal runs of the image's valid positions (the invalid rows of a padded
rectangle are never read) and reduce their sums in a fixed order through
distributed shared memory, then the mean, the ``1/p`` power and the L2 norm.
No scratch, no atomics: two calls give the same bits.

Both entry points keep the TPU kernel's L2N exactly: ``pooled / (sqrt(sum
pooled^2) + 1e-6)`` with no 1e-24 floor (unlike ``ops.normalization.l2n``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Both are differentiable: when grad mode is on
and ``feats`` or ``p`` needs a gradient, the call goes through a
``torch.autograd.Function`` (on either device) whose forward is that same
launch or plain version and whose backward is the VJP of the plain version,
recomputed on the saved inputs. That is the JAX package's rule: its custom
VJPs (``_gem_l2n_bwd``, ``_gem_l2n_rect_bwd``) differentiate its jnp
oracles, and there is no backward kernel. ``dfeats`` comes back in the
input's dtype, ``dp`` with ``p``'s shape; ``sizes`` gets none.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Union

import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build

GEM_EPS = 1e-6
L2N_EPS = 1e-6


def launch_plan(C: int, bf16: bool = False) -> dict:
    """The kernel's launch plan for a 16-byte-aligned map of C channels, as
    ``csrc/gem_l2n.cu`` computes it, and how many of its clusters the current
    CUDA device holds at once. For the record only: the launch needs none of
    it."""
    keys = ("cluster", "threads", "threads_across_channels", "row_lanes", "finish_slice",
            "clusters_at_once")
    out = (ctypes.c_int * len(keys))()
    _build.check(_build.load("gem_l2n").gem_l2n_plan(C, int(bf16), out), "gem_l2n_plan")
    return dict(zip(keys, out))


def _as_p(p: Union[torch.Tensor, float], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(p, dtype=torch.float32, device=device).reshape(1)


def gem_l2n_plain(feats: torch.Tensor, p, sizes: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of both kernels. feats: [B, H, W, C] or
    [B, N, C] (unmasked only); sizes: [B, 2] valid (h, w) or None."""
    W = feats.shape[2] if feats.dim() == 4 else None
    feats = feats.reshape(feats.shape[0], -1, feats.shape[-1])
    p = _as_p(p, feats.device)[0]
    xp = torch.pow(torch.clamp(feats.float(), min=GEM_EPS), p)
    if sizes is None:
        pooled = xp.sum(dim=1) / xp.shape[1]
    else:
        if W is None:
            raise ValueError("sizes need feats as [B, H, W, C]")
        sizes = sizes.to(torch.int64)
        n = torch.arange(xp.shape[1], device=xp.device)
        valid = ((n // W)[None, :] < sizes[:, 0:1]) & ((n % W)[None, :] < sizes[:, 1:2])
        xp = torch.where(valid[..., None], xp, torch.zeros((), device=xp.device))
        denom = torch.clamp(sizes[:, 0] * sizes[:, 1], min=1).float()
        pooled = xp.sum(dim=1) / denom[:, None]
    pooled = torch.pow(pooled, 1.0 / p)
    norm = torch.sqrt(torch.sum(pooled * pooled, dim=-1, keepdim=True))
    return pooled / (norm + L2N_EPS)


def _launch(feats3: torch.Tensor, p: torch.Tensor, sizes, W: int) -> torch.Tensor:
    if feats3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats must be float32 or bfloat16, got {feats3.dtype}")
    if not feats3.is_contiguous():
        raise ValueError("feats must be contiguous [B, N, C] (channels last)")
    if p.device != feats3.device or (sizes is not None and sizes.device != feats3.device):
        raise ValueError("feats, p and sizes must be on the same device")
    B, N, C = feats3.shape
    dev = feats3.device
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _build.load("gem_l2n")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gem_l2n_forward(
            feats3.data_ptr(), p.data_ptr(),
            None if sizes is None else sizes.data_ptr(),
            out.data_ptr(), B, N, W, C, int(feats3.dtype == torch.bfloat16), stream)
    _build.check(err, "gem_l2n_forward")
    return out


def _forward(feats: torch.Tensor, p: torch.Tensor, sizes) -> torch.Tensor:
    """The plain version for CPU tensors; the kernel for CUDA ones, counted
    on the entry point it serves (``sizes`` None: ``gem_l2n_fused``)."""
    if feats.device.type == "cpu":
        return gem_l2n_plain(feats, p, sizes)
    B, C = feats.shape[0], feats.shape[-1]
    W = 1 if sizes is None else feats.shape[2]
    entry = gem_l2n_fused if sizes is None else gem_l2n_fused_rect
    # both entry points launch one kernel; while a profiler records, a range
    # named after the entry point tells them apart in its trace
    with (torch.profiler.record_function(entry.__name__) if torch.autograd._profiler_enabled()
          else contextlib.nullcontext()):
        out = _launch(feats.reshape(B, -1, C), p.detach(), sizes, W)
    entry.launches += 1
    return out


class _GemL2N(torch.autograd.Function):
    """Forward: :func:`_forward`. Backward: the VJP of
    :func:`gem_l2n_plain` at the saved inputs."""

    @staticmethod
    def forward(ctx, feats, p, sizes):
        ctx.save_for_backward(feats, p, sizes)
        return _forward(feats, p, sizes)

    @staticmethod
    def backward(ctx, g):
        feats, p, sizes = ctx.saved_tensors
        need_f, need_p = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            f = feats.detach().requires_grad_(need_f)
            pp = p.detach().requires_grad_(need_p)
            wrt = [t for t, need in ((f, need_f), (pp, need_p)) if need]
            grads = list(torch.autograd.grad(gem_l2n_plain(f, pp, sizes), wrt, g))
        df = grads.pop(0) if need_f else None
        dp = grads.pop(0) if need_p else None
        return df, dp, None


def _apply(feats: torch.Tensor, p, sizes) -> torch.Tensor:
    p = _as_p(p, feats.device)
    if torch.is_grad_enabled() and (feats.requires_grad or p.requires_grad):
        return _GemL2N.apply(feats, p, sizes)
    return _forward(feats, p, sizes)


def gem_l2n_fused(feats: torch.Tensor, p) -> torch.Tensor:
    """Fused ``l2n(gem(feats, p))``. feats: [B, H, W, C] or [B, N, C] -> [B, C] f32."""
    if feats.dim() not in (3, 4):
        raise ValueError(f"feats must be [B, N, C] or [B, H, W, C], got {tuple(feats.shape)}")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    if feats.device.type == "cuda" and not feats.is_contiguous():
        raise ValueError("feats must be contiguous (channels last)")
    return _apply(feats, p, None)


def gem_l2n_fused_rect(feats: torch.Tensor, p, sizes: torch.Tensor) -> torch.Tensor:
    """Masked fused GeM + L2N for top-left-rectangle batches.

    feats: [B, H, W, C]; sizes: [B, 2] int32 valid (h, w) per image -> [B, C] f32.
    """
    if feats.dim() != 4:
        raise ValueError(f"feats must be [B, H, W, C], got {tuple(feats.shape)}")
    B, H, W, C = feats.shape
    if tuple(sizes.shape) != (B, 2):
        raise ValueError(f"sizes must be [{B}, 2], got {tuple(sizes.shape)}")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {feats.device}")
    if feats.device.type == "cuda":
        if sizes.dtype != torch.int32 or not sizes.is_contiguous():
            raise TypeError("sizes must be a contiguous int32 tensor")
        if not feats.is_contiguous():
            # the channels_last trunk output permuted to [B, H, W, C] is contiguous
            raise ValueError("feats must be contiguous [B, H, W, C] (channels last)")
    return _apply(feats, p, sizes)


gem_l2n_fused.launches = 0
gem_l2n_fused_rect.launches = 0
