"""Command-line entry points, the JAX package's ``cli.py`` on the port.

Usage:
    python -m image_retrieval_for_image_based_localization_tpu_torch.cli evaluate \\
        --dataset roxford5k --data-root /data --arch resnet50 --pooling gem \\
        --image-size 1024 --multiscale --whitening pca
    python -m image_retrieval_for_image_based_localization_tpu_torch.cli extract \\
        --images img1.jpg img2.jpg --arch resnet50 --out descs.npy
    python -m image_retrieval_for_image_based_localization_tpu_torch.cli serve \\
        --index index.npz --no-model
    python -m image_retrieval_for_image_based_localization_tpu_torch.cli fullsystem \\
        --n-images 64  # decode, device and end-to-end img/s

Every command that computes runs on the card (``--device cuda``, the
default, raises without one); ``--device cpu`` runs the plain PyTorch
versions (``synth`` and ``download`` only write files and take no
device). ``--checkpoint`` takes this package's run directory, a torch
``.pth``/``.pt`` state dict, or a run directory of the JAX package (its
Orbax ``best`` checkpoint, read without Orbax by ``utils/orbax.py``), and
``train --resume`` takes this package's run directory or the JAX
package's (its Orbax ``latest``, optimizer state included).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


class NotPorted(Exception):
    """A flag value of the JAX CLI that the port does not take; ``main``
    prints it and returns 2."""


def _read_names(path):
    if not path:
        return None
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu (the plain PyTorch "
                        "versions of the kernels)")


def _model_args(p: argparse.ArgumentParser):
    _device_arg(p)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--pooling", default="gem",
                   choices=["gem", "gemmp", "mac", "spoc", "rmac", "netvlad"])
    p.add_argument("--regional", action="store_true",
                   help="cirtorch Rpool: the base pool per R-MAC region (forces --exact)")
    p.add_argument("--whiten-dim", type=int, default=None,
                   help="learned FC whitening output dim")
    p.add_argument("--netvlad-clusters", type=int, default=64,
                   help="NetVLAD cluster count K (descriptor dim = K*C)")
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--multiscale", action="store_true",
                   help="use the [1, 1/sqrt2, 1/2] pyramid")
    p.add_argument("--exact", action="store_true",
                   help="exact-shape extraction (no spatial padding)")
    p.add_argument("--upscale", action="store_true",
                   help="also grow small images to --image-size (default: shrink only)")
    p.add_argument("--resize-filter", default="lanczos", choices=["lanczos", "bilinear"],
                   help="host resize filter (lanczos = reference parity)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 trunk compute")
    p.add_argument("--pallas", action="store_true",
                   help="the hand-written CUDA head kernel (the JAX flag's name)")
    p.add_argument("--checkpoint", default=None,
                   help="a run directory (its 'best') of this package or of the JAX package "
                        "(Orbax), or a torch state_dict .pth/.pt")
    p.add_argument("--network", default=None,
                   help="pretrained zoo network name: verify or fetch its .pth under "
                        "--data-root, rebuild the model from its meta (arch, pooling, "
                        "whitening, clusters), load its weights and use its pre-learned Lw "
                        "whitening if it has one")


def _build_extract_cfg(args):
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
        DEFAULT_SCALES,
        ExtractConfig,
        ModelConfig,
    )

    return ExtractConfig(
        model=ModelConfig(
            arch=args.arch,
            pooling=args.pooling,
            regional=args.regional,
            whiten_dim=args.whiten_dim,
            netvlad_clusters=args.netvlad_clusters,
            dtype="bfloat16" if args.bf16 else "float32",
            use_pallas=args.pallas,
        ),
        image_size=args.image_size,
        batch_size=args.batch_size,
        scales=DEFAULT_SCALES if args.multiscale else (1.0,),
        exact=args.exact,
        upscale=args.upscale,
        resize_filter=args.resize_filter,
    )


def _load_state_dict(args):
    """``--checkpoint`` as this package's ``state_dict``, or None."""
    path = args.checkpoint
    if path is None:
        return None
    import torch

    from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
        cirtorch_to_torchvision_keys,
    )

    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cirtorch_to_torchvision_keys(sd.get("state_dict", sd), args.arch)
    from image_retrieval_for_image_based_localization_tpu_torch.models.flax_port import (
        variables_to_state_dict,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.checkpoint import (
        is_jax_checkpoint,
        load_checkpoint,
    )

    tree, _ = load_checkpoint(path, name="best")
    if is_jax_checkpoint(path, "best"):
        variables = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}
        return variables_to_state_dict(variables, args.arch)
    return tree["model"]


def _resolve_network(args):
    """``--network NAME``: verify or fetch a pretrained zoo ``.pth`` (under
    ``--data-root``) and load it. Sets ``args.arch``, ``pooling``,
    ``regional``, ``whiten_dim`` and ``netvlad_clusters`` to the checkpoint
    meta's values, so :func:`_build_extract_cfg` builds the matching model,
    and returns ``(state_dict, whitening_mP_or_None)``; ``(None, None)``
    without the flag."""
    if args.network is None:
        return None, None
    from image_retrieval_for_image_based_localization_tpu_torch.models.zoo import (
        load_pretrained,
    )

    # the weights go to the Extractor, which puts them on --device
    model, mP = load_pretrained(args.network, data_root=args.data_root or "data",
                                whitening_scale="ms" if args.multiscale else "ss", device="cpu")
    args.arch = model.arch
    args.pooling = model.pooling
    args.regional = model.regional
    args.whiten_dim = model.whiten_dim
    args.netvlad_clusters = model.netvlad_clusters
    return model.state_dict(), mP


def _extractor(args, mesh=None, state_dict=None):
    """The Extractor of the model arguments, with ``--checkpoint``'s weights,
    else ``state_dict`` (``--network``'s), else seeded random ones."""
    from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor

    sd = _load_state_dict(args)
    return Extractor(_build_extract_cfg(args), state_dict=state_dict if sd is None else sd,
                     device=args.device, mesh=mesh)


def cmd_extract(argv):
    p = argparse.ArgumentParser(prog="extract")
    _model_args(p)
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--data-root", default="data", help="cache root for --network's checkpoint")
    args = p.parse_args(argv)

    net_sd, _ = _resolve_network(args)
    descs = _extractor(args, state_dict=net_sd).extract(args.images)
    np.save(args.out, descs)
    print(f"wrote {descs.shape} descriptors to {args.out}")


def cmd_evaluate(argv):
    p = argparse.ArgumentParser(prog="evaluate")
    _model_args(p)
    p.add_argument("--dataset", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--whitening", default="none", choices=["pca", "lw", "none"])
    p.add_argument("--whiten-dims", type=int, default=None)
    p.add_argument("--strict-whitening", action="store_true",
                   help="strict-reference PCA (no auto-shrinkage/floor)")
    p.add_argument("--whitening-file", default=None,
                   help="npz with pre-learned m/P applied instead of learning from the "
                        "eval gallery")
    p.add_argument("--qe", type=int, default=0, metavar="NQE",
                   help="alpha-query-expansion neighbor count (0 = off)")
    p.add_argument("--qe-alpha", type=float, default=3.0,
                   help="alphaQE weight exponent (0 = average QE)")
    p.add_argument("--dba", type=int, default=0, metavar="NQE",
                   help="database-side augmentation neighbor count at index build (0 = off)")
    p.add_argument("--dba-alpha", type=float, default=3.0)
    p.add_argument("--diffusion", action="store_true",
                   help="kNN-graph diffusion re-ranking; dense ranking path only")
    p.add_argument("--diffusion-k", type=int, default=50, help="graph neighbors per row")
    p.add_argument("--diffusion-seeds", type=int, default=10, help="seed matches per query")
    p.add_argument("--ann", default=None, choices=["ivf", "pq", "approx"],
                   help="evaluate from an approximate top-K shortlist (missing positives "
                        "count as never retrieved); 'approx' runs exact search here")
    p.add_argument("--shortlist-k", type=int, default=100, help="shortlist depth K for --ann")
    p.add_argument("--recall-ks", default=None, metavar="K1,K2,...",
                   help="also report localization recall@k at these depths")
    p.add_argument("--ann-nprobe", type=int, default=8)
    p.add_argument("--ann-clusters", type=int, default=None)
    p.add_argument("--ann-m", type=int, default=None, help="PQ code bytes/row (default D/32)")
    p.add_argument("--ann-refine", type=int, default=0)
    p.add_argument("--ann-opq", type=int, default=0)
    p.add_argument("--ann-recall-target", type=float, default=0.95,
                   help="recall target for --ann approx")
    p.add_argument("--sharded", action="store_true", help="use the sharded gallery")
    p.add_argument("--mesh", default=None, metavar="DxG",
                   help="mesh shape data x gallery, e.g. 2x2: data-parallel extraction "
                        "over D and G row shards, the D x G shards split over the "
                        "processes, each process's on its device (default: one shard "
                        "per local device)")
    p.add_argument("--metrics-out", default=None)
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.data.download import (
        TEST_MANIFESTS,
        download_test,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
        configdataset,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness import (
        evaluate_dataset,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import IndexConfig
    from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
        MetricsLogger,
    )

    mesh = None
    if args.mesh:
        from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
            group_size,
            initialize_distributed,
        )
        from image_retrieval_for_image_based_localization_tpu_torch.parallel.mesh import (
            create_mesh,
        )
        from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
            resolve_device,
        )

        # several processes join from JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES
        # and JAX_PROCESS_ID, as the JAX package's launcher sets them
        initialize_distributed(device=args.device)
        d, g = (int(v) for v in args.mesh.lower().split("x"))
        world = group_size()
        if (d * g) % world:
            raise SystemExit(f"--mesh {args.mesh}: {d * g} shards over {world} processes")
        # this process's share of the D x G shards, all on its device
        mesh = create_mesh([d, g], devices=[resolve_device(args.device)] * (d * g // world))
    net_sd, whitening_mP = _resolve_network(args)
    if args.whitening_file:
        z = np.load(args.whitening_file)
        whitening_mP = (z["m"], z["P"])  # in place of the network's Lw
    if args.dataset in TEST_MANIFESTS:
        # the reference's test.py: fetch the dataset if it is absent (offline:
        # an error that lists the paths to place)
        download_test(args.data_root, args.dataset)
    ex = _extractor(args, mesh=mesh, state_dict=net_sd)
    ann_kwargs = {"ivf": {"nprobe": args.ann_nprobe, "n_clusters": args.ann_clusters},
                  "pq": {"m": args.ann_m, "refine": args.ann_refine,
                         "opq_iters": args.ann_opq},
                  "approx": {"recall_target": args.ann_recall_target}}.get(args.ann)
    evaluate_dataset(
        configdataset(args.dataset, args.data_root),
        ex.cfg,
        IndexConfig(whitening=None if args.whitening == "none" else args.whitening,
                    whiten_dims=args.whiten_dims, strict_whitening=args.strict_whitening,
                    dba_nqe=args.dba, dba_alpha=args.dba_alpha),
        extractor=ex,
        logger=MetricsLogger(args.metrics_out, echo=True),
        device=args.device,
        mesh=mesh,
        use_sharded_index=args.sharded,
        whitening_mP=whitening_mP,
        qe_nqe=args.qe,
        qe_alpha=args.qe_alpha,
        diffusion=args.diffusion,
        diffusion_kwargs={"k_graph": args.diffusion_k, "k_seed": args.diffusion_seeds},
        ann=args.ann,
        ann_kwargs=ann_kwargs,
        shortlist_k=args.shortlist_k,
        recall_ks=(None if args.recall_ks is None else
                   [int(v) for v in args.recall_ks.split(",") if v]),
    )


def cmd_train(argv):
    p = argparse.ArgumentParser(prog="train")
    _model_args(p)
    p.add_argument("--loss", default="contrastive", choices=["contrastive", "triplet"])
    p.add_argument("--margin", type=float, default=0.7)
    p.add_argument("--lr", type=float, default=1e-6)
    p.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="trunk compute dtype (parameters and optimizer state stay float32)")
    p.add_argument("--momentum", type=float, default=0.9, help="SGD momentum")
    p.add_argument("--update-every", type=int, default=1,
                   help="gradient accumulation: apply the optimizer every k-th tuple batch")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--n-neg", type=int, default=5)
    p.add_argument("--batch-tuples", type=int, default=5)
    p.add_argument("--qsize", type=int, default=None,
                   help="query pairs sampled per epoch (reference: 2000)")
    p.add_argument("--poolsize", type=int, default=None,
                   help="negative-pool images sampled per epoch (reference: 20000)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--resume", default=None,
                   help="run directory to resume from ('latest'): this package's or the JAX "
                        "package's")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize trunk activations in the backward (lower peak memory)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the generated synthetic corpus")
    p.add_argument("--synth-scenes", type=int, default=12)
    p.add_argument("--synth-views", type=int, default=4)
    p.add_argument("--data-root", default=os.path.join(tempfile.gettempdir(), "irtpu_data"))
    args = p.parse_args(argv)
    if args.network is not None:
        # the JAX trainer takes the flag and ignores it (it trains from its
        # own init); the port refuses it rather than copy a silent no-op
        raise NotPorted("--network: training does not start from a zoo network; pass its "
                        ".pth as --checkpoint to evaluate it, or train from scratch")
    from image_retrieval_for_image_based_localization_tpu_torch.training.loop import (
        run_training,
    )

    run_training(args, device=args.device)


def cmd_synth(argv):
    p = argparse.ArgumentParser(prog="synth")
    p.add_argument("--root", required=True)
    p.add_argument("--name", default="synthcity")
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--views", type=int, default=5)
    p.add_argument("--distractors", type=int, default=10)
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
        make_synthetic_dataset,
    )

    ds = make_synthetic_dataset(args.root, name=args.name, n_scenes=args.scenes,
                                views_per_scene=args.views, n_distractors=args.distractors)
    print(f"created {ds.name}: {ds.n} db images, {ds.nq} queries at {ds.images_dir}")


def cmd_config(argv):
    p = argparse.ArgumentParser(prog="config")
    _device_arg(p)
    p.add_argument("n", type=int, choices=[1, 2, 3, 4, 5], help="graded benchmark config")
    p.add_argument("--data-root", default=None)
    p.add_argument("--synth-root", default=None)
    p.add_argument("--log", default=None, help="JSONL path for the run's metrics")
    p.add_argument("--out-dir", default=None,
                   help="config 5: directory for the index artifact and the pairs file")
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        run_graded_config,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
        MetricsLogger,
    )

    run_graded_config(args.n, data_root=args.data_root, synth_root=args.synth_root,
                      logger=MetricsLogger(path=args.log, echo=True) if args.log else None,
                      out_dir=args.out_dir, device=args.device)


def cmd_parity(argv):
    """The bucketed-vs-exact extraction delta (``benchmarks.measure_bucketing_delta``):
    mAP both ways on the synthetic corpus, and the stress set's cosines."""
    p = argparse.ArgumentParser(prog="parity")
    _device_arg(p)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--synth-root", default=os.path.join(tempfile.gettempdir(), "irtpu_synth"))
    p.add_argument("--checkpoint", default=None,
                   help="a run directory of this package or of the JAX package (Orbax), or "
                        "a torch state_dict .pth/.pt (random weights without it: noisy "
                        "deltas)")
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        measure_bucketing_delta,
    )

    print(measure_bucketing_delta(arch=args.arch, image_size=args.image_size,
                                  batch_size=args.batch_size, synth_root=args.synth_root,
                                  state_dict=_load_state_dict(args), device=args.device))


def cmd_build_index(argv):
    p = argparse.ArgumentParser(prog="build-index")
    _device_arg(p)
    p.add_argument("--descriptors", required=True, help=".npy [N, D] file")
    p.add_argument("--out", required=True, help="output index .npz")
    p.add_argument("--whitening", default="pca", choices=["pca", "lw", "none"])
    p.add_argument("--whiten-dims", type=int, default=None)
    p.add_argument("--whitening-file", default=None,
                   help="npz with pre-learned m/P applied instead of learning")
    p.add_argument("--dba", type=int, default=0, metavar="NQE",
                   help="database-side augmentation neighbor count (0 = off)")
    p.add_argument("--dba-alpha", type=float, default=3.0)
    p.add_argument("--ivf", type=int, default=None, nargs="?", const=0, metavar="C",
                   help="also build an IVF quantizer with C partitions (bare --ivf: "
                        "sqrt(N)), saved as <out>.ivf.npz")
    p.add_argument("--ivf-dtype", default="f32", choices=("f32", "bf16", "int8"),
                   help="IVF partition storage")
    p.add_argument("--pq", type=int, default=None, nargs="?", const=0, metavar="M",
                   help="also build PQ codes with M bytes a row (bare --pq: D/32); with "
                        "--ivf (f32) an IVF-PQ index <out>.ivfpq.npz, alone <out>.pq.npz")
    p.add_argument("--external-gallery", action="store_true",
                   help="store the gallery as an uncompressed <out>.gallery.npy sidecar, "
                        "loaded back memory-mapped")
    p.add_argument("--opq", type=int, default=0, metavar="ITERS",
                   help="with --pq: learn an OPQ rotation with this many iterations")
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
    from image_retrieval_for_image_based_localization_tpu_torch.utils.config import IndexConfig

    descs = np.load(args.descriptors)
    wh = None if args.whitening == "none" else args.whitening
    whitening_mP = None
    if args.whitening_file:
        z = np.load(args.whitening_file)
        whitening_mP = (z["m"], z["P"])
    elif wh == "lw":
        p.error("lw whitening needs matching pairs; pass the training loop's saved "
                "whitening via --whitening-file, or use Index.build(pairs=...) directly")
    index = Index.build(descs, IndexConfig(whitening=wh, whiten_dims=args.whiten_dims,
                                           dba_nqe=args.dba, dba_alpha=args.dba_alpha),
                        whitening_mP=whitening_mP, device=args.device)
    index.save(args.out, external_gallery=args.external_gallery)
    print(f"built index over {descs.shape} -> {args.out}")
    stem = args.out.removesuffix(".npz")
    ivf = None
    if args.ivf is not None:
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import (
            IVFIndex,
        )

        ivf = IVFIndex.build(index.gallery, n_clusters=args.ivf or None, dtype=args.ivf_dtype,
                             device=args.device)
        ivf.save(stem + ".ivf.npz")
        print(f"built IVF quantizer: C={ivf.centroids.shape[0]} "
              f"pad_ratio={ivf.pad_ratio:.2f} -> {stem}.ivf.npz")
    if args.pq is not None:
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
            IVFPQIndex,
            PQIndex,
        )

        if ivf is not None:
            if args.ivf_dtype != "f32":
                p.error("--pq with --ivf needs --ivf-dtype f32 (residuals of quantized rows "
                        "double-compress)")
            pq = IVFPQIndex.from_ivf(ivf, m=args.pq or None, opq_iters=args.opq,
                                     device=args.device)
            pq_path = stem + ".ivfpq.npz"
        else:
            pq = PQIndex.build(index.gallery, m=args.pq or None, opq_iters=args.opq,
                               device=args.device)
            pq_path = stem + ".pq.npz"
        pq.save(pq_path)
        M, D = pq.codebooks.shape[0], index.gallery.shape[1]
        print(f"built PQ codes: M={M} ({D * 4 / M:.0f}x compression) -> {pq_path}")


def cmd_query(argv):
    p = argparse.ArgumentParser(prog="query")
    _device_arg(p)
    p.add_argument("--index", required=True, help="index .npz from build-index")
    p.add_argument("--queries", required=True, help=".npy [Nq, D] query descriptors")
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--qe", type=int, default=0, metavar="NQE",
                   help="alpha-query-expansion neighbor count (0 = off)")
    p.add_argument("--qe-alpha", type=float, default=3.0,
                   help="alphaQE weight exponent (0 = average QE)")
    p.add_argument("--ivf", default=None, metavar="IVF_NPZ",
                   help="IVF quantizer from build-index --ivf: probe search")
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument("--pq", default=None, metavar="PQ_NPZ",
                   help="PQ artifact from build-index --pq (.pq.npz or .ivfpq.npz): ADC "
                        "search over the codes")
    p.add_argument("--refine", type=int, default=0, metavar="R",
                   help="with --pq: rescore the top-R ADC candidates exactly")
    p.add_argument("--approx", type=float, default=None, metavar="RECALL", nargs="?",
                   const=0.95,
                   help="the JAX package's approximate selection at this recall target; "
                        "exact search here, which meets any target")
    p.add_argument("--out", default=None, help="optional .npz for scores/indices")
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index

    if args.approx is not None and (args.pq or args.ivf or args.sharded):
        p.error("--approx is the single-device full-gallery selection knob; drop "
                "--ivf/--pq/--sharded")
    if args.qe and (args.pq or args.ivf):
        p.error("--qe re-ranks against the full gallery (exact path, the serving rule); "
                "drop --ivf/--pq or drop --qe")
    if args.pq and args.ivf:
        p.error("--pq and --ivf are exclusive (an .ivfpq.npz artifact already embeds its "
                "coarse quantizer)")

    index = Index.load(args.index, device=args.device)
    qd = np.load(args.queries)
    if args.pq:
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
            IVFPQIndex,
            load_pq_artifact,
        )

        pq = load_pq_artifact(args.pq, device=args.device)
        qt = index.transform_queries(qd)
        kw = dict(k=args.k, refine=args.refine, gallery=index.gallery if args.refine else None)
        if args.sharded:  # codes row-sharded over the gallery axis
            if isinstance(pq, IVFPQIndex):
                p.error("--sharded --pq takes a flat .pq.npz artifact (cluster-sharded "
                        "approximate search is --ivf --sharded)")
            from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_pq import (  # noqa: E501
                ShardedPQ,
            )

            pq = ShardedPQ(pq)
        elif isinstance(pq, IVFPQIndex):
            kw["nprobe"] = args.nprobe
        scores, idx = pq.search(qt, **kw)
    elif args.ivf:
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import (
            IVFIndex,
        )

        ivf = IVFIndex.load(args.ivf, device=args.device)
        if args.sharded:  # partitions sharded across the gallery axis
            from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_ivf import (  # noqa: E501
                ShardedIVF,
            )

            ivf = ShardedIVF(ivf)
        scores, idx = ivf.search(index.transform_queries(qd), k=args.k, nprobe=args.nprobe)
    elif args.sharded:
        from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_index import (  # noqa: E501
            ShardedIndex,
        )
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.query_expansion import (  # noqa: E501
            expand_via_sharded,
        )

        sindex = ShardedIndex.from_index(index)
        if args.qe:
            qx = expand_via_sharded(sindex, index.gallery, qd, args.qe, alpha=args.qe_alpha)
            scores, idx = sindex.query(qx, k=args.k, pre_transformed=True)
        else:
            scores, idx = sindex.query(qd, k=args.k)
    else:
        scores, idx = index.query(
            qd, k=args.k, qe_nqe=args.qe, qe_alpha=args.qe_alpha,
            method="exact" if args.approx is None else "approx",
            recall_target=0.95 if args.approx is None else args.approx)
    if args.out:
        np.savez(args.out, scores=scores, indices=idx)
        print(f"wrote {args.out}")
    for qi in range(min(len(idx), 10)):
        print(f"q{qi}: " + " ".join(f"{i}:{s:.4f}" for s, i in zip(scores[qi], idx[qi])))


def cmd_shortlist(argv):
    """Retrieval as localization hand-off: query images -> top-k shortlist
    pairs file (hloc-style ``<query> <db>`` lines) for a pose pipeline."""
    p = argparse.ArgumentParser(prog="shortlist")
    _model_args(p)
    p.add_argument("--index", required=True, help="index .npz from build-index")
    p.add_argument("--images", nargs="+", required=True, help="query image paths")
    p.add_argument("-k", type=int, default=20)
    p.add_argument("--db-names", default=None,
                   help="optional text file, one db image name per line")
    p.add_argument("--out", required=True, help="pairs file to write")
    p.add_argument("--data-root", default="data", help="cache root for --network's checkpoint")
    p.add_argument("--qe", type=int, default=0, metavar="NQE",
                   help="alphaQE expansion before the shortlist cut")
    p.add_argument("--qe-alpha", type=float, default=3.0)
    p.add_argument("--diffusion", action="store_true",
                   help="diffusion re-ranking before the shortlist cut")
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.localization import (
        localize_shortlist,
    )
    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index

    index = Index.load(args.index, device=args.device)
    net_sd, _ = _resolve_network(args)
    qd = _extractor(args, state_dict=net_sd).extract(args.images)
    qnames = [os.path.basename(q) for q in args.images]
    pairs, _ = localize_shortlist(index, qd, qnames, db_names=_read_names(args.db_names),
                                  k=args.k, out_path=args.out, qe_nqe=args.qe,
                                  qe_alpha=args.qe_alpha, diffusion=args.diffusion)
    print(f"wrote {len(pairs)} pairs ({len(qnames)} queries x k={args.k}) to {args.out}")


def cmd_serve(argv):
    """The long-lived serving process (``serving.py``): the gallery and the
    model on the card, JSON over HTTP."""
    p = argparse.ArgumentParser(prog="serve")
    _model_args(p)
    p.add_argument("--index", required=True, help="index .npz from build-index")
    p.add_argument("--db-names", default=None,
                   help="optional text file, one db image name per line")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7878)
    p.add_argument("--no-model", action="store_true",
                   help="serve /query only (no extractor)")
    p.add_argument("--data-root", default="data", help="cache root for --network's checkpoint")
    p.add_argument("--ivf", default=None, metavar="IVF_NPZ",
                   help="IVF quantizer from build-index --ivf: probe search by default "
                        "(exact=1 per request still forces exact)")
    p.add_argument("--nprobe", type=int, default=8,
                   help="default partitions probed per IVF(-PQ) query")
    p.add_argument("--pq", default=None, metavar="PQ_NPZ",
                   help="PQ artifact from build-index --pq: ADC search by default "
                        "(exclusive with --ivf; exact=1 per request still forces exact)")
    p.add_argument("--refine", type=int, default=0, metavar="R",
                   help="default exact-rescore depth for --pq queries")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="micro-batching: coalesce concurrent plain queries arriving within "
                        "this window into one search (0 = off)")
    p.add_argument("--max-batch", type=int, default=64, help="requests per micro-batch, at most")
    p.add_argument("--max-inflight", type=int, default=64,
                   help="admission cap: requests inside the service at once (waiting and "
                        "executing); the rest get 503 + Retry-After (0 = unlimited)")
    p.add_argument("--request-timeout-s", type=float, default=30.0,
                   help="seconds a request may wait for the device before 504")
    args = p.parse_args(argv)
    if args.pq and args.ivf:
        p.error("--pq and --ivf are exclusive (an .ivfpq.npz artifact already embeds its "
                "coarse quantizer)")

    from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
    from image_retrieval_for_image_based_localization_tpu_torch.serving import serve

    ex = None
    if not args.no_model:
        net_sd, _ = _resolve_network(args)
        ex = _extractor(args, state_dict=net_sd)
    index = Index.load(args.index, device=args.device)
    ivf = pq = None
    if args.ivf:
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import (
            IVFIndex,
        )

        ivf = IVFIndex.load(args.ivf, device=args.device)
    if args.pq:
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
            load_pq_artifact,
        )

        pq = load_pq_artifact(args.pq, device=args.device)
    serve(index, extractor=ex, db_names=_read_names(args.db_names), host=args.host,
          port=args.port, ivf=ivf, nprobe=args.nprobe, pq=pq, refine=args.refine,
          batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
          max_inflight=args.max_inflight, request_timeout_s=args.request_timeout_s,
          reload_paths={"index": args.index, "ivf": args.ivf, "pq": args.pq,
                        "db_names": args.db_names},
          device=args.device)


def cmd_fullsystem(argv):
    """Disk JPEG -> decode -> device -> descriptor throughput
    (``benchmarks.run_full_system_bench``), one JSON line."""
    p = argparse.ArgumentParser(
        prog="fullsystem",
        description="disk JPEG -> decode -> device -> descriptor throughput, with the "
                    "decode-alone rate per thread count")
    _device_arg(p)
    p.add_argument("--n-images", type=int, default=64)
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "irtpu_fullsys"))
    args = p.parse_args(argv)

    import json

    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        run_full_system_bench,
    )

    print(json.dumps(run_full_system_bench(n_images=args.n_images, image_size=args.image_size,
                                           arch=args.arch, batch_size=args.batch_size,
                                           root=args.root, device=args.device)))


def cmd_download(argv):
    """Verify or fetch datasets and pretrained networks (``data/download.py``)."""
    p = argparse.ArgumentParser(
        prog="download",
        description="verify or fetch datasets and pretrained networks (set IRTPU_OFFLINE=1 "
                    "to verify only)")
    p.add_argument("names", nargs="+",
                   help="dataset names (roxford5k, rparis6k, oxford5k, paris6k, "
                        "retrieval-SfM-120k) or zoo network names")
    p.add_argument("--data-root", default="data")
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.data.download import (
        TEST_MANIFESTS,
        TRAIN_MANIFESTS,
        ZOO_MANIFESTS,
        download_network,
        download_test,
        download_train,
    )

    for name in args.names:
        if name in TEST_MANIFESTS:
            download_test(args.data_root, name)
        elif name in TRAIN_MANIFESTS:
            download_train(args.data_root, name)
        elif name in ZOO_MANIFESTS:
            download_network(args.data_root, name)
        else:
            raise SystemExit(f"unknown artifact '{name}'; known: "
                             f"{sorted([*TEST_MANIFESTS, *TRAIN_MANIFESTS, *ZOO_MANIFESTS])}")
        print(f"{name}: present under {args.data_root}")


def cmd_bench_ann(argv):
    """Recall-vs-q/s sweep across the search family (exact, IVF, PQ, OPQ,
    IVF-PQ) on a clustered synthetic corpus."""
    p = argparse.ArgumentParser(prog="bench-ann")
    _device_arg(p)
    p.add_argument("-n", type=int, default=20_000, help="gallery rows")
    p.add_argument("-d", type=int, default=256, help="descriptor dim")
    p.add_argument("--nq", type=int, default=256)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--clusters", type=int, default=None)
    p.add_argument("-m", type=int, default=None, help="PQ code bytes/row")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import run_ann_bench

    out = run_ann_bench(n=args.n, d=args.d, nq=args.nq, k=args.k, n_clusters=args.clusters,
                        m=args.m, reps=args.reps, device=args.device)
    w = max(len(s) for s in out)
    print(f"{'method':{w}s}  recall@{args.k:<3d} qps")
    for name, row in out.items():
        print(f"{name:{w}s}  {row['recall_at_k']:8.4f}  {row['qps']:10.1f}")


def cmd_bench_serve(argv):
    """Closed-loop load test of the HTTP server: q/s and client latency
    percentiles, unbatched and micro-batched, on one in-process server."""
    p = argparse.ArgumentParser(prog="bench-serve")
    _device_arg(p)
    p.add_argument("-n", type=int, default=10_000, help="gallery rows")
    p.add_argument("-d", type=int, default=256)
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        run_serving_bench,
    )

    out = run_serving_bench(n=args.n, d=args.d, concurrency=args.concurrency,
                            requests=args.requests, k=args.k,
                            batch_window_ms=args.batch_window_ms, device=args.device)
    for mode in ("unbatched", "batched"):
        r = out[mode]
        print(f"{mode:10s} qps={r['qps']:8.1f}  p50={r['lat_p50_ms']:7.2f}ms"
              f"  p95={r['lat_p95_ms']:7.2f}ms  p99={r['lat_p99_ms']:7.2f}ms")
    print(f"micro-batching qps ratio: {out['speedup']['qps_ratio']}x")


def cmd_bench_train(argv):
    """Train-step throughput (tuples/s, images/s) at the reference's
    training geometry."""
    p = argparse.ArgumentParser(prog="bench-train")
    _device_arg(p)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--pooling", default="gem")
    p.add_argument("--image-size", type=int, default=362)
    p.add_argument("--batch-tuples", type=int, default=5)
    p.add_argument("--n-neg", type=int, default=5)
    p.add_argument("--loss", default="contrastive", choices=("contrastive", "triplet"))
    p.add_argument("--remat", action="store_true")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)

    from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
        run_training_bench,
    )

    out = run_training_bench(arch=args.arch, pooling=args.pooling, image_size=args.image_size,
                             batch_tuples=args.batch_tuples, n_neg=args.n_neg, loss=args.loss,
                             remat=args.remat, dtype=args.dtype, reps=args.reps,
                             device=args.device)
    print(f"{out['arch']}+{out['pooling']} @{out['image_size']}px "
          f"b{out['batch_tuples']}x{2 + out['n_neg']} remat={out['remat']} "
          f"dtype={out['dtype']}")
    print(f"tuples/s={out['tuples_per_sec']:.2f}  images/s={out['images_per_sec']:.2f}  "
          f"step p50={out['lat_p50_ms']:.1f}ms p95={out['lat_p95_ms']:.1f}ms")


COMMANDS = {
    "download": cmd_download,
    "extract": cmd_extract,
    "fullsystem": cmd_fullsystem,
    "bench-ann": cmd_bench_ann,
    "bench-serve": cmd_bench_serve,
    "bench-train": cmd_bench_train,
    "evaluate": cmd_evaluate,
    "train": cmd_train,
    "synth": cmd_synth,
    "config": cmd_config,
    "parity": cmd_parity,
    "build-index": cmd_build_index,
    "query": cmd_query,
    "serve": cmd_serve,
    "shortlist": cmd_shortlist,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: ... {{{'|'.join(COMMANDS)}}} [args]", file=sys.stderr)
        return 2
    try:
        return COMMANDS[argv[0]](argv[1:]) or 0
    except NotPorted as e:
        print(f"{argv[0]}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
