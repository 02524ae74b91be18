from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (  # noqa: F401
    approx_topk,
    full_ranks,
    knn_search,
    score_matrix,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import (  # noqa: F401
    Index,
)
