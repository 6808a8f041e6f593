"""Model zoo of the port: the dense transformer family and the CNN."""

from .common import ArchConfig  # noqa: F401
from .convnet import CNNConfig  # noqa: F401
from .registry import get_cache_layout, get_model, get_weight_mask  # noqa: F401
