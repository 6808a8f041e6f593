"""Hand-written Hopper kernels of the port and their routing.

  ``fused_linear``     qq / qi / ii / qq_blk (fused quantize ->) int8 GEMM
                       and the GEMM epilogue gemm_epi (CUDA + plain)
  ``fused_attention``  fused attention: decode over the int8 cache, the
                       qflow training forward and backward
  ``fused_chain``      the norm -> GEMM chain and the whole-layer decode
                       block
  ``bfp_quant``        the standalone quantizer of the unfused rung
  ``int8_matmul``      the int8 GEMM of the unfused rung (tensor cores)
  ``rounding_bits``    the stochastic-rounding words (threefry2x32, hash)
  ``ops``              both as standalone ops (sweeps, benchmarks)
  ``dispatch``         plans, decisions and the plain-version switch
  ``build``            nvcc build + ctypes loading of ``csrc/*.cu``
  ``ref``              plain torch oracles

Modules are imported on use; importing this package builds nothing.
"""
