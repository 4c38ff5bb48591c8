"""String-keyed registry (reference utils/registry.py:9-45 and
modeling/registry.py:5-14): maps config strings to implementations.
The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
registry.py``."""

from typing import Any, Optional


class Registry(dict):
    def register(self, name: str, module: Optional[Any] = None):
        """``register(name, obj)`` registers ``obj``; ``register(name)``
        is a decorator.  A name registers once."""
        if module is not None:
            self._do_register(name, module)
            return module

        def deco(fn):
            self._do_register(name, fn)
            return fn

        return deco

    def _do_register(self, name: str, module: Any):
        if name in self:
            raise KeyError(f"{name} already registered")
        self[name] = module


# the model-component registries (modeling/registry.py)
BACKBONES = Registry()
RPN_HEADS = Registry()
ROI_BOX_FEATURE_EXTRACTORS = Registry()
ROI_BOX_PREDICTOR = Registry()
ROI_MASK_FEATURE_EXTRACTORS = Registry()
ROI_MASK_PREDICTOR = Registry()
ROI_KEYPOINT_FEATURE_EXTRACTORS = Registry()
ROI_KEYPOINT_PREDICTOR = Registry()
MMSS_HEADS = Registry()
LANGUAGE_BACKBONES = Registry()
