"""PyTorch/CUDA port of the image-retrieval framework, for NVIDIA Hopper.

Sits beside the JAX package (``image_retrieval_for_image_based_localization_tpu``),
which stays the reference, with the same sub-package layout. It imports
torch, numpy and the standard library only. Hand-written CUDA kernels live
in ``csrc/`` and are built with nvcc at first use (``ops.kernels``).

    extract_features(images, cfg)  -> [N, D] descriptors
    build_index(descriptors, cfg)  -> Index (whitening + gallery)
    query(index, qdescriptors, k)  -> (scores, indices)
    IVFIndex / PQIndex / IVFPQIndex -> compressed-gallery search
    ShardedIndex / ShardedIVF      -> search over a gallery sharded by rows
                                      across devices and processes (parallel/)
    run_training(args)             -> tuple training with hard-negative mining

Entry points run on the card unless ``device="cpu"`` is passed.
"""

__version__ = "0.1.0"

from image_retrieval_for_image_based_localization_tpu_torch.api import (  # noqa: F401
    Extractor,
    build_index,
    extract_features,
    extract_vectors,
    query,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel import (  # noqa: F401
    ShardedIndex,
    ShardedIVF,
    create_mesh,
    default_mesh,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import (  # noqa: F401
    IVFIndex,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (  # noqa: F401
    IVFPQIndex,
    PQIndex,
    load_pq_artifact,
)
from image_retrieval_for_image_based_localization_tpu_torch.training import (  # noqa: F401
    TrainConfig,
    TrainState,
    TupleSet,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_val_step,
    mine_epoch_tuples,
    mine_hard_negatives,
    train_epoch,
    validate,
)
from image_retrieval_for_image_based_localization_tpu_torch.training.loop import (  # noqa: F401
    run_training,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (  # noqa: F401
    GRADED_CONFIGS,
    ExtractConfig,
    IndexConfig,
    ModelConfig,
)
