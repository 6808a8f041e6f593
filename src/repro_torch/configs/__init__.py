"""Architecture configs of the port (dense family): each module defines
CONFIG (the published config) and SMOKE (a reduced config for CPU tests)."""

from .base import ARCH_IDS, get_config, get_smoke_config  # noqa: F401
