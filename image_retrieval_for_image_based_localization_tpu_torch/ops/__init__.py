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
