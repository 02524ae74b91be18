from image_retrieval_for_image_based_localization_tpu_torch.models.init import init_random_  # noqa: F401
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (  # noqa: F401
    ResNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (  # noqa: F401
    NetVLAD,
    RetrievalNet,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import VGGTrunk  # noqa: F401
