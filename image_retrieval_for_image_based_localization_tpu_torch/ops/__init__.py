from image_retrieval_for_image_based_localization_tpu_torch.ops.losses import (  # noqa: F401
    contrastive_loss,
    triplet_loss,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.netvlad import (  # noqa: F401
    netvlad_aggregate,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.normalization import (  # noqa: F401
    l2n,
    powerlaw,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.pooling import (  # noqa: F401
    POOLING_FNS,
    gem,
    mac,
    rmac,
    rmac_bucketed,
    rmac_regions,
    rpool,
    spoc,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.whitening import (  # noqa: F401
    pca_whiten_learn,
    whiten_apply,
    whiten_learn,
)
