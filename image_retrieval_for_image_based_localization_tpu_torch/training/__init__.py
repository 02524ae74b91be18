"""Training: the tuple train step, hard-negative mining, the training loop
and NetVLAD's k-means init (the JAX package's ``training/``)."""

from image_retrieval_for_image_based_localization_tpu_torch.training.mining import (  # noqa: F401
    TupleSet,
    mine_epoch_tuples,
    mine_hard_negatives,
)
from image_retrieval_for_image_based_localization_tpu_torch.training.trainer import (  # noqa: F401
    TrainConfig,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_val_step,
    train_epoch,
    validate,
)
