"""Hand-written CUDA kernels of the serving path and their plain versions.

  ref.py               plain PyTorch versions (CPU path, ground truth)
  csrc/*.cu            CUDA C++ kernels for Hopper (sm_90a)
  build.py             nvcc build at first use + ctypes loading
  rmsnorm.py           wrapper of csrc/rmsnorm.cu
  decode_attention.py  wrappers of csrc/decode_attention.cu
  ops.py               impl dispatch + XFA static costs
"""
