from image_retrieval_for_image_based_localization_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    default_mesh,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_index import (  # noqa: F401
    ShardedIndex,
    sharded_knn,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_ivf import (  # noqa: F401
    ShardedIVF,
    sharded_ivf_search,
)
