"""Extraction traffic for a NetVLAD configuration: the ``extract`` driver's
lists, window, sample and fault site, with the configuration's own model
(a VGG-16 trunk, NetVLAD with ``clusters`` centroids, ``netvlad_prel2``
and FC whitening to ``whiten_dim``), its seeded weights
(:func:`state_dict`), the plain reference ``reference/vgg_netvlad.py``, and
counters of the NetVLAD head's route over the window, read from the
kernels' launch counts and the model's calls. The control rounds
the head's operands (both NetVLAD products and the whitening's) to TF32
with the trunk in float32: the cheaper head kernel, at one TF32 product in
place of three, that the comparison has to refuse."""

import math

import numpy as np
import torch

from retrieval_bench import synth
from retrieval_bench.drivers.extract import Cell as _Extract
from retrieval_bench.reference import extract as ref
from retrieval_bench.reference import vgg_netvlad

from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
from image_retrieval_for_image_based_localization_tpu_torch.ops import kernels
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    ModelConfig,
)


def extract_config(cfg: dict) -> ExtractConfig:
    mc, ec = cfg["model"], cfg["extract"]
    return ExtractConfig(
        model=ModelConfig(arch=mc["arch"], pooling=mc["pooling"], whiten_dim=mc["whiten_dim"],
                          netvlad_clusters=mc["clusters"], dtype=mc["dtype"],
                          use_pallas=mc["use_pallas"], netvlad_prel2=mc["netvlad_prel2"]),
        image_size=ec["image_size"], scales=tuple(ec["scales"]),
        batch_size=ec["batch_size"], bucket_multiple=ec["bucket_multiple"])


@torch.no_grad()
def state_dict(cfg: dict, seed: int, device) -> dict:
    """The port's layout, float32 on ``device``, from the seed's weights
    generator: He-normal convolutions, N(0, ``conv_bias_std``) biases;
    ``clusters`` unit centroids c_k with the assignment w_k = 2 alpha c_k and
    a zero bias (hloc's ``score_bias=False``); the whitening FC's weights
    normal of variance 1 / (K C) and its bias N(0, ``fc_bias_std``) (the
    second figure of each N a standard deviation)."""
    mc, wc = cfg["model"], cfg["weights"]
    g = synth.generator(seed, "weights", device)
    convs = vgg_netvlad.param_shapes()
    flat = torch.randn(sum(math.prod(s) for _, s in convs), generator=g, device=device)
    biases = wc["conv_bias_std"] * torch.randn(sum(s[0] for _, s in convs), generator=g,
                                               device=device)
    sd, at, bt = {}, 0, 0
    for idx, shape in convs:
        n = math.prod(shape)
        he = (2.0 / (n // shape[0])) ** 0.5
        sd[f"features.{idx}.weight"] = flat[at : at + n].view(shape) * he
        sd[f"features.{idx}.bias"] = biases[bt : bt + shape[0]]
        at, bt = at + n, bt + shape[0]
    K, C, D = mc["clusters"], vgg_netvlad.CHANNELS, mc["whiten_dim"]
    cen = torch.randn((K, C), generator=g, device=device)
    cen = cen / cen.norm(dim=1, keepdim=True)
    sd["pool.centroids"] = cen
    sd["pool.conv.weight"] = (2.0 * wc["alpha"] * cen).reshape(K, C, 1, 1)
    sd["pool.conv.bias"] = torch.zeros(K, device=device)
    sd["whiten.weight"] = torch.randn((D, K * C), generator=g, device=device) * (K * C) ** -0.5
    sd["whiten.bias"] = wc["fc_bias_std"] * torch.randn(D, generator=g, device=device)
    return sd


class Cell(_Extract):
    def setup(self) -> None:
        sd = state_dict(self.cfg, self.seed, self.device)
        self.ex = Extractor(extract_config(self.cfg), state_dict=sd, device=self.device)
        del sd
        self.pool = synth.images(self.cfg, self.tr["pool_per_shape"], self.seed, self.device)
        warm = []
        n = self.tr["warm_batches_per_shape"] * self.cfg["extract"]["batch_size"]
        for imgs in self.pool.values():
            warm += [imgs[j % len(imgs)] for j in range(n)]
        self.ex.extract(warm)
        self.routes = None

    def window(self, seconds: float) -> None:
        """The window, its NetVLAD head calls by route: each model call is
        one head call (one scale, unfused trunk), ``kernel_full`` and
        ``kernel_rect`` the launches of ``netvlad_fused`` and
        ``netvlad_fused_rect``, ``plain`` the rest."""
        calls = []
        hook = self.ex.model.register_forward_hook(lambda *_: calls.append(1))
        before = kernels.launch_counts()
        try:
            super().window(seconds)
        finally:
            hook.remove()
        after = kernels.launch_counts()
        full, rect = (after[n] - before[n] for n in ("netvlad_fused", "netvlad_fused_rect"))
        self.routes = {"kernel_full": full, "kernel_rect": rect,
                       "plain": len(calls) - full - rect}

    def counters(self) -> dict:
        mc, ec = self.cfg["model"], self.cfg["extract"]
        return {"images": dict(self.shapes), "arch": mc["arch"], "dtype": mc["dtype"],
                "channels": vgg_netvlad.CHANNELS, "clusters": mc["clusters"],
                "whiten_dim": mc["whiten_dim"], "scales": list(ec["scales"]),
                "bucket": ec["bucket_multiple"], "host_batch": self.host_batch,
                "netvlad_routes": self.routes}

    def check(self) -> dict:
        outs = dict(self.outputs)
        picks = self.sample()
        prog = np.stack([outs[li][pos] for _, li, pos, _ in picks])
        refd = reference_descriptors(self.cfg, self.seed, self.device,
                                     [(shape, j) for shape, _, _, j in picks],
                                     self.tr["pool_per_shape"])
        return ref.compare(prog, refd)


def reference_descriptors(cfg, seed, device, items, per_shape, control=None,
                          head_control=None) -> np.ndarray:
    """The reference's descriptors of pool images ``(shape, position)``,
    the weights and the pool made again from the seed; ``control`` rounds
    the trunk's operands, ``head_control`` the head's."""
    ref.tf32_off()
    sd = state_dict(cfg, seed, device)
    pool = synth.images(cfg, per_shape, seed, device)
    ec = cfg["extract"]
    if list(ec["scales"]) != [1.0]:
        raise ValueError(f"the NetVLAD reference runs one scale, not {ec['scales']}")
    return np.stack([
        vgg_netvlad.descriptor(pool[shape][j], sd, ec["image_size"], ec["bucket_multiple"],
                               control=control, head_control=head_control,
                               device=device).cpu().numpy()
        for shape, j in items])


def _control_items(cfg, traffic, seed) -> list:
    per = max(1, traffic["check_images"] // len(cfg["images"]["shapes"]))
    r = synth.rng(seed, "check")
    return [(tuple(s), int(j)) for s in sorted(map(tuple, cfg["images"]["shapes"]))
            for j in r.choice(traffic["pool_per_shape"], per)]


def control_numbers(cfg, traffic, seed, seconds, device, where: str = "head") -> dict:
    """The reference with the head's products (``where`` "head") or the
    trunk's convolutions ("trunk") on TF32 operands, against the reference,
    on as many pool images a shape as the check samples. The trunk's reading
    on the card, for seed S:

        python3 -c "import sys, torch; from retrieval_bench import harness;
        from retrieval_bench.drivers import extract_netvlad as d;
        _, _, cfg, tr = harness.resolve(
            'vgg16-netvlad-pitts30k.extract-db-netvlad', harness.load_benchmark());
        torch.set_grad_enabled(False);
        print(d.control_numbers(cfg, tr, int(sys.argv[1]), 0, 'cuda', 'trunk'))" S
    """
    items = _control_items(cfg, traffic, seed)
    n = traffic["pool_per_shape"]
    low = {"head": {"head_control": "tf32"}, "trunk": {"control": "tf32"}}[where]
    return ref.compare(reference_descriptors(cfg, seed, device, items, n, **low),
                       reference_descriptors(cfg, seed, device, items, n))
