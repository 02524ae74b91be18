"""``s2d_stem=True`` in the port against the JAX package's s2d stem, on the CPU.

The JAX package's ``s2d_stem`` computes the resnet stem's 7x7/stride-2
convolution as space-to-depth(2) + a 4x4/stride-1 convolution on the same
``[7, 7, Cin, F]`` kernel at the standard tree path (exact up to f32 sum
order; odd inputs keep the direct convolution). The port takes the flag
and runs its standard stem: the same function of the same parameter. Held
here: the JAX ``Extractor`` with ``s2d_stem=True`` against the port's with
the same weights within 2e-5 on even (bucketed) and odd (exact-shape)
inputs, and the port's two settings bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_retrieval_for_image_based_localization_tpu_torch as port
from irtpu import Extractor as JExtractor
from irtpu.models.torch_port import port_retrieval_net
from irtpu.utils import config as jcfg

from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _images(seed=0):
    rng = np.random.RandomState(seed)
    # 64 x 64 and 48 x 64 buckets, and an odd 57 x 45 image for exact shapes
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8)
            for h, w in ((64, 64), (48, 64), (64, 48), (57, 45))]


@pytest.mark.parametrize("arch,exact", [("resnet18", False), ("resnet50", False),
                                        ("resnet18", True)],
                         ids=["resnet18", "resnet50", "resnet18-exact"])
def test_s2d_stem_matches_the_jax_s2d_extractor(arch, exact):
    net = RetrievalNet(arch, "gem")
    init_random_(net, torch.Generator().manual_seed(7))
    sd = net.state_dict()
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, arch))
    kw = dict(image_size=64, batch_size=4, exact=exact)
    ex_j = JExtractor(jcfg.ExtractConfig(model=jcfg.ModelConfig(arch=arch, s2d_stem=True),
                                         **kw), variables=variables)
    ex_t = port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch=arch, s2d_stem=True),
                                             **kw), state_dict=sd, device="cpu")
    ex_std = port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch=arch), **kw),
                            state_dict=sd, device="cpu")
    imgs = _images()
    got = ex_t.extract(imgs)
    np.testing.assert_allclose(got, np.asarray(ex_j.extract(imgs)), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got, ex_std.extract(imgs))
