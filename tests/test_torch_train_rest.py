"""The rest of what the JAX trainer trains, one train step each against the
JAX package on the same weights (the JAX model's ``init``, carried across
with ``variables_to_state_dict``) and the same seeded tuples (2 tuples x
3 images at 64 px, ImageNet-normalized blocky images with ragged valid
extents, as tests/test_torch_training.py makes them): the DenseNet (slimmed
as tests/test_torch_trunks.py slims it, under an arch name both packages
register), AlexNet and SqueezeNet 1.1 trunks, the GeMmp, R-MAC (masked and
unmasked) and regional heads with the learned whitening
(tests/test_torch_train_bf16.py holds bf16 training and remat on these
helpers).

Tolerances, each with its reason (tests/test_torch_training.py's):
  * against the JAX trainer's loss function run in float64 (the JAX f32
    gradient on the CPU strays 1-2e-2 of max|g| from it, the port's stays
    within 1e-4): the loss within 1e-5 relative, every parameter's gradient
    within 1e-4 of its tensor's max|g| or 1e-6 absolute, the BN running
    statistics within 1e-5 relative of each tensor's max.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from irtpu.models import densenet as j_densenet
from irtpu.models import retrieval_net as j_retrieval_net
from irtpu.models.retrieval_net import RetrievalNet as JNet
from irtpu.ops.losses import contrastive_loss as j_contrastive
from irtpu.training import trainer as jtrainer

from image_retrieval_for_image_based_localization_tpu_torch.models import densenet as p_densenet
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    retrieval_net as p_retrieval_net,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
    variables_to_state_dict,
)
from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)
from torch_threads import parity_threads  # noqa: F401  (a module fixture: torch's threads)

HW = 64
B, T = 2, 3
GRAD_REL, GRAD_ATOL, LOSS_REL, STATS_REL = 1e-4, 1e-6, 1e-5, 1e-5
SLIM = "densenet_slim"  # densenet121's structure: growth 8, 2-3 layers a block
SLIM_SPEC = (8, (2, 3, 2, 2), 16)
CFG = TrainConfig(loss="contrastive", margin=0.7, lr=1e-3, lr_decay=1.0, weight_decay=0.0,
                  optimizer="sgd", momentum=0.0, n_neg=1, batch_tuples=B)


@pytest.fixture(scope="module", autouse=True)
def slim_densenet():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (j_densenet, p_densenet):
            mp.setitem(mod.DENSENET_SPECS, SLIM, SLIM_SPEC)
        dim = p_densenet.densenet_out_channels(SLIM)
        for table in (j_retrieval_net.OUTPUT_DIM, p_retrieval_net.OUTPUT_DIM):
            mp.setitem(table, SLIM, dim)
        yield


def _batch(seed=5, ragged=True):
    """tests/test_torch_training.py's tuples: blocky u8 images whose second
    and third images leave padding in the feature map, and the labels."""
    rng = np.random.RandomState(seed)
    px = (np.kron(rng.rand(B, T, HW // 8, HW // 8, 3), np.ones((1, 1, 8, 8, 1))) * 255
          ).astype(np.uint8)
    sizes = np.array([[HW, HW], [HW // 2, HW], [HW, HW // 2 - 4]] if ragged else [[HW, HW]] * T,
                     np.int32)
    sizes = np.tile(sizes, (B, 1, 1))
    for b in range(B):
        for t in range(T):
            h, w = sizes[b, t]
            px[b, t, h:, :] = 0
            px[b, t, :, w:] = 0
    labels = np.tile(np.array([[0, 1, -1]], np.int32), (B, 1))
    row = np.arange(HW)[None, None, :, None]
    col = np.arange(HW)[None, None, None, :]
    mask = (row < sizes[..., 0, None, None]) & (col < sizes[..., 1, None, None])
    x = (px.astype(np.float32) / 255.0 - np.asarray([0.485, 0.456, 0.406], np.float32)) \
        / np.asarray([0.229, 0.224, 0.225], np.float32)
    return px, sizes, labels, (x * mask[..., None]).astype(np.float32), mask


def _model_kw(arch, pooling, whiten_dim=None, regional=False):
    return dict(arch=arch, pooling=pooling, whiten_dim=whiten_dim, regional=regional)


@functools.lru_cache(maxsize=None)
def _weights(arch, pooling, whiten_dim=None, regional=False, seed=0):
    """The JAX model's initial variables (numpy; ``jm.init``, as
    tests/test_torch_training.py starts from) and the same weights as the
    port's state_dict; callers must not mutate them."""
    jm = JNet(**_model_kw(arch, pooling, whiten_dim, regional))
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                                  jnp.zeros((1, HW, HW, 3))))
    return variables_to_state_dict(v, arch), v


def _jax_loss_fn(jm, v, x, mask, labels, remat=False):
    """``(loss, new batch_stats), grads`` of the JAX trainer's loss function
    (``trainer._loss_fn``); a trunk without BN (alexnet, squeezenet) gets the
    same forward and loss written out, since ``_loss_fn`` asks flax for
    ``mutable=[]`` there and cannot unpack its (out, state) pair (ROADMAP C9)."""
    m = None if mask is None else jnp.asarray(mask)
    lab = jnp.asarray(labels)
    stats = v.get("batch_stats", {})
    cfg = dataclasses.replace(CFG, remat=remat)
    if stats:
        return jax.jit(jax.value_and_grad(functools.partial(jtrainer._loss_fn, jm, cfg),
                                          has_aux=True))(v["params"], stats, x, lab, mask=m)

    def loss_fn(params):
        fm = None if m is None else m.reshape(B * T, HW, HW)
        desc = jm.apply({"params": params}, x.reshape(B * T, HW, HW, 3), mask=fm,
                        train=True).reshape(B, T, -1)
        return j_contrastive(desc, lab, margin=CFG.margin)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return (loss, {}), grads


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, pooling, whiten_dim, regional, masked, dtype="float64", remat=False):
    """Loss, gradients and new batch statistics of the JAX trainer's loss
    function, as the port's state_dict (float32 numpy)."""
    _, v = _weights(arch, pooling, whiten_dim, regional)
    _, _, labels, x, mask = _batch(ragged=masked)
    mask = mask if masked else None
    kw = _model_kw(arch, pooling, whiten_dim, regional)
    if dtype == "float64":
        with jax.enable_x64(True):
            jm = JNet(**kw, dtype=jnp.float64)
            v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
            (loss, stats), grads = _jax_loss_fn(jm, v64, jnp.asarray(x, jnp.float64), mask,
                                                labels, remat)
    else:
        jm = JNet(**kw, dtype=getattr(jnp, dtype))
        (loss, stats), grads = _jax_loss_fn(jm, jax.tree.map(jnp.asarray, v), jnp.asarray(x),
                                            mask, labels, remat)
    tree = {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), grads)}
    if stats:
        tree["batch_stats"] = jax.tree.map(lambda a: np.asarray(a, np.float32), stats)
    return float(loss), variables_to_state_dict(tree, arch)


def _port_step(arch, pooling, whiten_dim=None, regional=False, masked=True, use_kernel=False,
               dtype="float32", remat=False):
    """One port train step from the seeded weights: the u8 step (its mask)
    when ``masked``, else the f32 step on every pixel valid."""
    sd, _ = _weights(arch, pooling, whiten_dim, regional)
    px, sizes, labels, x, _ = _batch(ragged=masked)
    cfg = dataclasses.replace(CFG, remat=remat)
    m = RetrievalNet(**_model_kw(arch, pooling, whiten_dim, regional), use_kernel=use_kernel,
                     dtype=dtype)
    state = create_train_state(m, cfg, state_dict=sd, device="cpu")
    if masked:
        state, loss = make_train_step(m, cfg, from_u8=True)(state, px, sizes, labels)
    else:
        state, loss = make_train_step(m, cfg)(state, x, labels)
    assert state.step == 1 and state.micro == 0
    return state, float(loss)


def _worst(state, want, rel=GRAD_REL, atol=GRAD_ATOL):
    """The largest gradient error over the bound (> 1 fails), and its name."""
    worst, name = 0.0, None
    for n, p in state.model.named_parameters():
        w = want[n].numpy()
        err = float(np.abs(p.grad.numpy() - w).max())
        r = err / max(rel * float(np.abs(w).max()), atol)
        if r > worst:
            worst, name = r, n
    return worst, name


def _stats_close(state, want, rel=STATS_REL):
    sd = state.model.state_dict()
    n = 0
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            w = w.numpy()
            err = float(np.abs(sd[k].numpy() - w).max())
            assert err <= rel * float(np.abs(w).max()), (k, err)
            n += 1
    return n


# (arch, pooling, whiten_dim, regional, masked u8, kernel head)
CASES = [
    (SLIM, "gem", None, False, True, True),
    ("alexnet", "gem", None, False, True, True),
    ("squeezenet1_1", "gem", None, False, False, False),
    ("resnet18", "gemmp", None, False, True, False),
    ("resnet18", "rmac", None, False, True, False),
    ("resnet18", "rmac", None, False, False, False),
    ("resnet18", "gem", 16, True, False, False),
]


@pytest.mark.parametrize(
    "arch,pooling,whiten_dim,regional,masked,use_kernel", CASES,
    ids=[f"{a}-{p}{'-regional' if r else ''}{f'-whiten{w}' if w else ''}-"
         f"{'u8' if m else 'f32'}-{'kernel' if k else 'plain'}" for a, p, w, r, m, k in CASES])
def test_step_matches_jax_trainer(arch, pooling, whiten_dim, regional, masked, use_kernel):
    want_loss, want = _jax_reference(arch, pooling, whiten_dim, regional, masked)
    state, loss = _port_step(arch, pooling, whiten_dim, regional, masked, use_kernel)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_REL)
    worst, name = _worst(state, want)
    assert worst <= 1.0, (name, worst)
    n_stats = _stats_close(state, want)
    assert n_stats > 0 or arch in ("alexnet", "squeezenet1_1")
    named = dict(state.model.named_parameters())
    if pooling == "gemmp":  # one exponent a channel, each with its gradient
        assert named["pool.p"].shape == (512,) and bool((named["pool.p"].grad != 0).all())
    if whiten_dim:
        assert float(named["whiten.weight"].grad.abs().max()) > 0
    # every conv weight trains
    for n, p in named.items():
        if p.dim() == 4:
            assert float(p.grad.abs().max()) > 0, n


def test_masked_regional_step_raises_as_jax():
    """A regional model takes exact shapes only: the masked (u8) step raises
    the JAX package's ValueError, here and there."""
    px, sizes, labels, x, mask = _batch()
    _, v = _weights("resnet18", "gem", 16, True)
    jm = JNet(**_model_kw("resnet18", "gem", 16, True))
    with pytest.raises(ValueError, match="regional pooling requires exact shapes"):
        _jax_loss_fn(jm, jax.tree.map(jnp.asarray, v), jnp.asarray(x), mask, labels)
    with pytest.raises(ValueError, match="regional pooling requires exact shapes"):
        _port_step("resnet18", "gem", 16, True, masked=True)
