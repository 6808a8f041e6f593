"""Deterministic synthetic token streams of the port."""

from .pipeline import SyntheticLM, UniformLM  # noqa: F401
