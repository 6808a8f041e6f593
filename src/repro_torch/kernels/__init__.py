"""Hand-written Hopper kernels of the port and their routing.

  ``fused_linear``     qq / qi / ii (fused quantize ->) int8 GEMM (CUDA +
                       plain)
  ``fused_attention``  fused decode attention over the int8 cache
  ``dispatch``         plans, decisions and the plain-version switch
  ``build``            nvcc build + ctypes loading of ``csrc/*.cu``
  ``ref``              plain torch oracles

Modules are imported on use; importing this package builds nothing.
"""
