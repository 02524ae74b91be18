from image_retrieval_for_image_based_localization_tpu_torch.models.alexnet import (  # noqa: F401
    AlexNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.densenet import (  # noqa: F401
    DenseNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.init import init_random_  # noqa: F401
from image_retrieval_for_image_based_localization_tpu_torch.models.resnet import (  # noqa: F401
    RESNET_SPECS,
    ResNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.retrieval_net import (  # noqa: F401
    OUTPUT_DIM,
    NetVLAD,
    RetrievalNet,
    build_trunk,
    create_model,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.squeezenet import (  # noqa: F401
    SqueezeNetTrunk,
)
from image_retrieval_for_image_based_localization_tpu_torch.models.vgg import VGGTrunk  # noqa: F401
