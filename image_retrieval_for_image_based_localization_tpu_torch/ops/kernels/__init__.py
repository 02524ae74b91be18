"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper carries a ``launches`` count that grows by one where it
launches its kernel (never on the CPU path), so a run can show which
kernels it went through.
"""

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.adc import (  # noqa: F401
    adc_scores,
    adc_scores_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bn_act import (  # noqa: F401
    bn_act,
    bn_act_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.bottleneck import (  # noqa: F401
    bottleneck_fused,
    bottleneck_fused_bf16,
    bottleneck_plain,
    fold_bn,
    pack_bf16,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.fused_topk import (  # noqa: F401
    fused_topk_plain,
    fused_topk_search,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.gem_l2n import (  # noqa: F401
    gem_l2n_fused,
    gem_l2n_fused_rect,
    gem_l2n_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.netvlad import (  # noqa: F401
    netvlad_fused,
    netvlad_fused_rect,
    netvlad_plain,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (  # noqa: F401
    blockmax_select,
    blockmax_topk_search,
    scores_blockmax,
    scores_blockmax_plain,
)

KERNELS = (gem_l2n_fused_rect, gem_l2n_fused, fused_topk_search, netvlad_fused_rect,
           netvlad_fused, scores_blockmax, adc_scores, bottleneck_fused, bottleneck_fused_bf16,
           bn_act)


SEARCH_KERNELS = (fused_topk_search, scores_blockmax)  # also count their small-batch form


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in SEARCH_KERNELS:
        fn.narrow_launches = 0


def launch_counts() -> dict:
    """Each kernel's launches by name, and for the exact-search kernels, as
    ``<name>_narrow``, how many of them took the small-batch form."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts.update({f"{fn.__name__}_narrow": fn.narrow_launches for fn in SEARCH_KERNELS})
    return counts
