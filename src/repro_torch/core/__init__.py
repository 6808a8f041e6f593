"""Integer arithmetic core: keys and rounding bits, the BFP mapping, the
numeric policy, fixed point, integer norms and the quantized ops."""

from .bfp import BFP, PER_TENSOR, QuantConfig, dequantize, quantize  # noqa: F401
from .policy import (FLOAT32, PAPER_INT8, QC_ROWS, QW_NONE,  # noqa: F401
                     QW_STACKED, QW_TENSOR, NumericPolicy)
