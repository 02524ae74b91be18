from image_retrieval_for_image_based_localization_tpu_torch.data.images import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageBatch,
    bucket_shape,
    load_image,
    make_batches,
    max_side_resize,
    normalize_images,
)
