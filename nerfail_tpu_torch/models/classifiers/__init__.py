from nerfail_tpu_torch.models.classifiers.registry import (
    CLASSIFIER_REGISTRY,
    classifier_input_size,
    get_classifier,
)

__all__ = ["get_classifier", "classifier_input_size", "CLASSIFIER_REGISTRY"]
