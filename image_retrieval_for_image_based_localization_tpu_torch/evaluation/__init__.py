from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (  # noqa: F401
    compute_ap,
    compute_map,
    compute_map_and_print,
    compute_map_revisited,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness import (  # noqa: F401
    evaluate_dataset,
)
