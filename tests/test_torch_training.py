"""The port's training step against the JAX package's trainer on the same
weights (carried across with ``variables_to_state_dict``) and the same
seeded inputs, at small sizes: resnet18 + GeM at 64 px and vgg16 + NetVLAD
(K = 8) at 32 px (a 2 x 2 feature map each), 2 tuples x 3 images.

Tolerances, each with its reason:
  * losses and their input gradients against the JAX losses: 1e-6 (the
    same f32 formulas);
  * train-mode BatchNorm against flax's: the unit-norm descriptors within
    1e-5 of their norm, the running statistics within 1e-5 relative of each
    tensor's max (f32 convolutions and reductions in another order);
  * one train step against the JAX trainer's loss function: the loss
    within 1e-5 relative, every parameter's gradient within 1e-4 of its
    tensor's max|g| or 1e-6 absolute (a deep f32 backward against a float64
    one), the BN running statistics within 1e-5 relative. The pixels are
    ImageNet-normalized blocky images, as both packages' steps feed them:
    on i.i.d. noise images, whose descriptors nearly coincide, the f32
    gradient of either package strays up to 6 % of max|g| from float64;
  * the optimizers on identical gradients: parameters within 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from irtpu.models import RetrievalNet as JNet
from irtpu.ops.losses import contrastive_loss as j_contrastive
from irtpu.ops.losses import triplet_loss as j_triplet
from irtpu.training import trainer as jtrainer

from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.fused_trunk import fold_trunk
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (
    ResNetTrunk,
    conv_bn,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.losses import (
    contrastive_loss,
    triplet_loss,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.mesh import Mesh
from image_retrieval_for_image_based_localization_tpu_torch.training import trainer
from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
    TrainConfig,
    TrainState,
    apply_micro_step,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    make_val_step,
    train_epoch,
    tuples_to_batch,
    validate,
)
from torch_threads import parity_threads  # noqa: F401  (a module fixture: torch's threads)

HW = 64      # resnet18, stride 32: a 2 x 2 feature map
VGG_HW = 32  # vgg16, stride 16: a 2 x 2 feature map
B, T = 2, 3
GRAD_REL, GRAD_ATOL, LOSS_REL = 1e-4, 1e-6, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _init(arch, seed, hw):
    """The JAX model and its initial variables (numpy), made once a module:
    each ``init`` compiles for seconds on the CPU. Callers must not mutate
    the arrays."""
    jm = JNet(arch=arch, pooling="gem" if arch == "resnet18" else "netvlad",
              netvlad_clusters=8)
    return jm, _np(jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3))))


# ---- losses ------------------------------------------------------------------


def _descs(seed, b=3, t=5, d=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    labels = np.tile(np.array([[0, 1, -1, -1, -1]], np.int32), (b, 1))
    return x, labels


@pytest.mark.parametrize("kind", ["contrastive", "triplet"])
def test_losses_and_input_gradients_match_jax(kind):
    x, labels = _descs(0)
    x[0, 3] = x[0, 0]  # a negative on the query: d2 = 0 < eps, the clip's branch
    t = torch.from_numpy(x).requires_grad_()
    if kind == "contrastive":
        got = contrastive_loss(t, torch.from_numpy(labels), margin=0.85)
        f = lambda d: j_contrastive(d, jnp.asarray(labels), margin=0.85)  # noqa: E731
    else:
        got = triplet_loss(t, margin=0.5)
        f = lambda d: j_triplet(d, margin=0.5)  # noqa: E731
    got.backward()
    want, grad = jax.value_and_grad(f)(jnp.asarray(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), rtol=0, atol=1e-6)
    assert np.isfinite(t.grad.numpy()).all()


# ---- train-mode BatchNorm ----------------------------------------------------


def _jax_resnet(seed=0, hw=HW):
    jm, v = _init("resnet18", seed, hw)
    # random running statistics, so the update's 0.9 * old term shows
    rng = np.random.RandomState(seed + 1)
    v = {"params": v["params"],
         "batch_stats": jax.tree.map(lambda a: jnp.asarray(
             np.abs(rng.randn(*a.shape)).astype(np.float32) * 0.5 + 0.5), v["batch_stats"])}
    return jm, v


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (name, err)


def test_train_mode_bn_matches_flax():
    jm, v = _jax_resnet()
    x = np.random.RandomState(3).randn(4, HW, HW, 3).astype(np.float32)
    want, upd = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    want_sd = variables_to_state_dict({"params": v["params"], "batch_stats": _np(
        upd["batch_stats"])}, "resnet18")
    m = RetrievalNet(arch="resnet18", pooling="gem")
    m.load_state_dict(variables_to_state_dict(_np(v), "resnet18"))
    m.train()
    got = m(torch.from_numpy(x))
    np.testing.assert_allclose(np.linalg.norm(np.asarray(want), axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    sd = m.state_dict()
    for k in want_sd:
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k].numpy(), want_sd[k].numpy(), 1e-5, k)


def test_train_mode_bn_stores_the_biased_variance():
    """The running variance moves toward the batch's biased variance
    (flax), not the unbiased one torch's own train mode stores."""
    bn = torch.nn.BatchNorm2d(2)
    conv = torch.nn.Conv2d(2, 2, 1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.eye(2).reshape(2, 2, 1, 1))
    y = torch.from_numpy(np.random.RandomState(4).randn(2, 2, 3, 3).astype(np.float32) * 2.0)
    bn.train()
    conv_bn(conv, bn, y)
    biased = y.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * torch.ones(2) + 0.1 * biased,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * y.mean(dim=(0, 2, 3)),
                               rtol=1e-6, atol=1e-6)


# ---- one train step against the JAX trainer -----------------------------------


def _batch(seed, hw=HW, ragged=True):
    """Seeded u8 tuples with ragged valid extents and zeroed padding (or
    every pixel valid), and the labels."""
    rng = np.random.RandomState(seed)
    # blocky random images (8 x 8 blocks): i.i.d. pixel noise gives every
    # image nearly the same descriptor, and the loss's (x - q) / |x - q|
    # is then f32 rounding noise in either package
    px = (np.kron(rng.rand(B, T, hw // 8, hw // 8, 3), np.ones((1, 1, 8, 8, 1))) * 255
          ).astype(np.uint8)
    # the second and third images leave padding in the 2 x 2 feature map
    sizes = np.array([[hw, hw], [hw // 2, hw], [hw, hw // 2 - 4]] if ragged else [[hw, hw]] * T,
                     np.int32)
    sizes = np.tile(sizes, (B, 1, 1))
    for b in range(B):
        for t in range(T):
            h, w = sizes[b, t]
            px[b, t, h:, :] = 0
            px[b, t, :, w:] = 0
    labels = np.tile(np.array([[0, 1, -1]], np.int32), (B, 1))
    return px, sizes, labels


def _jax_u8_input(px, sizes):
    """The JAX u8 step's preprocessing (trainer.py, make_train_step), in
    numpy: ``(u8 / 255 - mean) / std``, zeroed padding, and the mask."""
    hw = px.shape[2]
    row = np.arange(hw)[None, None, :, None]
    col = np.arange(hw)[None, None, None, :]
    mask = (row < sizes[..., 0, None, None]) & (col < sizes[..., 1, None, None])
    x = (px.astype(np.float32) / 255.0 - np.asarray([0.485, 0.456, 0.406], np.float32)) \
        / np.asarray([0.229, 0.224, 0.225], np.float32)
    return (x * mask[..., None]).astype(np.float32), mask


def _jax_reference(v, arch, pooling, cfg, x, mask, labels):
    """Loss, gradients and new batch statistics of the JAX trainer's loss
    function (``trainer._loss_fn``) at these weights and inputs, with the
    trunk in float64 (the head computes in f32 as the JAX head always does)
    and the JAX head's XLA form: its Pallas kernels run f32 only, and their
    VJP is that same oracle's (test_torch_head_grad.py holds the port's
    head Functions against it).
    float64, because the JAX package's own f32 gradient on the CPU strays
    from it by 1-2e-2 of max|g| on these resnet18 batches (measured; the
    port's f32 gradient stays within 7e-5 of it). A trunk without BN
    (vgg16) gets the same forward and loss written out: ``_loss_fn`` asks
    flax for ``mutable=[]`` when there are no batch statistics and then
    cannot unpack flax's (out, state) pair."""
    with jax.enable_x64(True):
        jm = JNet(arch=arch, pooling=pooling, netvlad_clusters=8, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        x64 = jnp.asarray(x, jnp.float64)
        m = None if mask is None else jnp.asarray(mask)
        lab = jnp.asarray(labels)
        stats = v64.get("batch_stats", {})
        if stats:
            (loss, new_stats), grads = jax.jit(jax.value_and_grad(
                functools.partial(jtrainer._loss_fn, jm, cfg), has_aux=True
            ))(v64["params"], stats, x64, lab, mask=m)
        else:
            def loss_fn(params):
                hw = x64.shape[2]
                fm = None if m is None else m.reshape(B * T, hw, hw)
                desc = jm.apply({"params": params}, x64.reshape(B * T, hw, hw, 3), mask=fm,
                                train=True).reshape(B, T, -1)
                return j_contrastive(desc, lab, margin=cfg.margin)

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v64["params"])
            new_stats = {}
        to32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
        return float(loss), to32(grads), to32(new_stats)


_REFERENCES = {}


def _sgd_cfg(loss):
    # a triplet margin that random-init descriptors violate: the loss and
    # its gradients are not zero
    return TrainConfig(loss=loss, margin=0.7 if loss == "contrastive" else 0.5, lr=1e-3,
                       lr_decay=1.0, weight_decay=0.0, optimizer="sgd", momentum=0.0,
                       n_neg=1, batch_tuples=B)


def _step_matches(v, arch, pooling, use_pallas, u8, cfg, seed, hw):
    px, sizes, labels = _batch(seed, hw, ragged=u8)
    x, mask = _jax_u8_input(px, sizes)
    if not u8:
        mask = None  # every pixel valid: the unmasked step and head
    key = (arch, seed, hw, u8, cfg.loss)
    if key not in _REFERENCES:  # the JAX reference runs the XLA head either way
        _REFERENCES[key] = _jax_reference(v, arch, pooling, cfg, x, mask, labels)
    want_loss, jgrads, jstats = _REFERENCES[key]
    m = RetrievalNet(arch=arch, pooling=pooling, use_kernel=use_pallas, netvlad_clusters=8)
    state = create_train_state(m, cfg, state_dict=variables_to_state_dict(v, arch),
                               device="cpu")
    if u8:
        state, loss = make_train_step(m, cfg, from_u8=True)(state, px, sizes, labels)
    else:
        state, loss = make_train_step(m, cfg)(state, x, labels)
    assert state.step == 1 and state.micro == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_REL)
    tree = {"params": jgrads}
    if jstats:
        tree["batch_stats"] = jstats
    want = variables_to_state_dict(tree, arch)
    named = dict(state.model.named_parameters())
    for name, p in named.items():
        w = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= max(GRAD_REL * float(np.abs(w).max()), GRAD_ATOL), (name, err)
    head = named["pool.p"] if pooling == "gem" else named["pool.centroids"]
    assert float(head.grad.abs().max()) > 0
    sd = state.model.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            _close(sd[k].numpy(), w.numpy(), 1e-5, k)


# (use_pallas, masked u8, loss): each value of each axis, every (kernel
# head, u8) pair; a kernel case and its plain twin share one JAX reference
RESNET_CASES = [(True, True, "contrastive"), (False, True, "contrastive"),
                (True, False, "triplet"), (False, False, "triplet")]


@pytest.mark.parametrize("use_pallas,u8,loss", RESNET_CASES,
                         ids=[f"{'kernel' if k else 'plain'}-{'u8' if u else 'f32'}-{lo}"
                              for k, u, lo in RESNET_CASES])
def test_resnet_gem_step_matches_jax_trainer(use_pallas, u8, loss):
    _, v = _init("resnet18", 0, HW)
    _step_matches(v, "resnet18", "gem", use_pallas, u8, _sgd_cfg(loss), seed=5, hw=HW)


@pytest.mark.parametrize("use_pallas,u8", [(True, True), (False, False)],
                         ids=["kernel-u8", "plain-f32"])
def test_vgg_netvlad_step_matches_jax(use_pallas, u8):
    _, v = _init("vgg16", 1, VGG_HW)
    _step_matches(v, "vgg16", "netvlad", use_pallas, u8, _sgd_cfg("contrastive"), seed=6,
                  hw=VGG_HW)


# ---- the optimizers on identical gradients -------------------------------------


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("update_every", [1, 2])
def test_optimizers_match_optax_on_identical_gradients(optimizer, update_every):
    """Three applied steps of the same gradient sequence, the lr decaying
    per epoch of two applied steps; with update_every = 2 the micro-batch
    gradients are averaged. optax forms Adam's bias corrections in f32
    (``1 - 0.999`` lands 1.3e-5 off) where torch forms them in double, which
    moves each step by ~6e-6 of the lr: lr = 0.01 keeps that under the
    1e-6 bound with room."""
    cfg = TrainConfig(optimizer=optimizer, lr=0.01, lr_decay=0.5, steps_per_epoch=2,
                      weight_decay=0.01, momentum=0.9, update_every=update_every)
    rng = np.random.RandomState(7)
    w0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) * 10.0 ** rng.randint(-3, 1)
             for _ in range(3 * update_every)]
    tx = jtrainer.make_optimizer(cfg)
    jp = {"w": jnp.asarray(w0)}
    jst = tx.init(jp)
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = make_optimizer(module.parameters(), cfg)
    state = TrainState(model=module, optimizer=opt, scheduler=sched)
    for g in grads:
        upd, jst = tx.update({"w": jnp.asarray(g)}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        if state.micro == 0:
            opt.zero_grad(set_to_none=True)
        if module.w.grad is None:
            module.w.grad = torch.from_numpy(g.copy())
        else:
            module.w.grad += torch.from_numpy(g)
        apply_micro_step(state, update_every)
        np.testing.assert_allclose(module.w.detach().numpy(), np.asarray(jp["w"]),
                                   rtol=0, atol=1e-6)
    assert state.step == len(grads) and state.micro == 0
    assert opt.param_groups[0]["lr"] == pytest.approx(0.01 * 0.5 ** 1)
    assert np.abs(module.w.detach().numpy() - w0).max() > 1e-3  # the parameters moved


# ---- the rest of the trainer ---------------------------------------------------


def test_train_epoch_validate_and_eval_step_run():
    cfg = TrainConfig(n_neg=1, lr=1e-3, batch_tuples=B)
    state = create_train_state(RetrievalNet(arch="resnet18"), cfg, seed=1, device="cpu")
    rng = np.random.RandomState(8)
    pixels, labels = tuples_to_batch(rng.rand(B, T, 32, 32, 3).astype(np.float32), 1)
    step = make_train_step(state.model, cfg)
    state, mean_loss = train_epoch(state, step, [(pixels, labels)] * 2)
    assert np.isfinite(mean_loss) and state.step == 2
    stats = state.model.features.bn1.running_var.clone()
    val = validate(state, make_val_step(state.model, cfg), [(pixels, labels)])
    desc = make_eval_step(state.model)(state, pixels)
    assert np.isfinite(val) and desc.shape == (B, T, 512)
    assert state.model.training  # returned to train mode
    assert torch.equal(stats, state.model.features.bn1.running_var)  # eval moved no statistic


def test_what_the_port_does_not_train_raises():
    """What stays refused raises; bf16 training, remat and a bf16 map through
    train-mode ``conv_bn``, refused until the port trained them, now build a
    train state and take a step (tests/test_torch_train_rest.py holds them
    against the JAX package)."""
    cfg = TrainConfig()
    # a data-parallel train mesh holds one card a process: shards of one
    # process on two devices are refused before anything reaches them
    two_cards = Mesh({"data": 2, "gallery": 1}, [torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="one process per card"):
        make_train_step(RetrievalNet(arch="resnet18"), cfg, mesh=two_cards)
    rng = np.random.RandomState(8)
    pixels, labels = tuples_to_batch(rng.rand(B, T, 32, 32, 3).astype(np.float32), 1)
    small = dataclasses.replace(cfg, n_neg=1, batch_tuples=B, lr=1e-3)
    for m, c in ((RetrievalNet(arch="resnet18", dtype="bfloat16"), small),
                 (RetrievalNet(arch="resnet18"), dataclasses.replace(small, remat=True))):
        state = create_train_state(m, c, seed=1, device="cpu")
        state, loss = make_train_step(m, c)(state, pixels, labels)
        assert state.step == 1 and np.isfinite(float(loss))
        assert all(p.grad is not None and p.dtype == torch.float32 for p in m.parameters())
    with pytest.raises(ValueError, match="GeM and NetVLAD"):
        make_train_step(RetrievalNet(arch="resnet18", pooling="mac", use_kernel=True), cfg)
    with pytest.raises(RuntimeError, match="fuse_blocks"):
        fold_trunk(ResNetTrunk("resnet50").train())
    bn = torch.nn.BatchNorm2d(4).train()
    conv = torch.nn.Conv2d(4, 4, 1, bias=False)
    x = torch.from_numpy(rng.randn(2, 4, 3, 3).astype(np.float32)).to(torch.bfloat16)
    out = conv_bn(conv, bn, x)
    assert out.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    out.float().square().sum().backward()
    assert float(conv.weight.grad.abs().max()) > 0 and float(bn.weight.grad.abs().max()) > 0


def test_u8_input_matches_the_jax_step_preprocessing():
    px, sizes, _ = _batch(9)
    x, mask = trainer.u8_to_input(torch.from_numpy(px), torch.from_numpy(sizes))
    row = np.arange(HW)[:, None]
    col = np.arange(HW)[None, :]
    want_mask = (row < sizes[..., 0, None, None]) & (col < sizes[..., 1, None, None])
    mean = jnp.asarray([0.485, 0.456, 0.406], jnp.float32)
    std = jnp.asarray([0.229, 0.224, 0.225], jnp.float32)
    want = (jnp.asarray(px).astype(jnp.float32) / 255.0 - mean) / std * want_mask[..., None]
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_train_config_matches_the_jax_package():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jtrainer.TrainConfig)}
    assert ours == theirs

