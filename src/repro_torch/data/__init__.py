"""Deterministic synthetic data of the port: token streams and images."""

from .pipeline import SyntheticLM, UniformLM  # noqa: F401
from .vision import SyntheticVision  # noqa: F401
