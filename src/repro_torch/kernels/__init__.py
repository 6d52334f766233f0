"""Hand-written CUDA kernels of the port and their plain versions.

  ref.py               plain PyTorch versions (CPU path, ground truth)
  csrc/*.cu            CUDA C++ kernels for Hopper (sm_90a)
  build.py             nvcc build at first use + ctypes loading
  rmsnorm.py           wrappers of csrc/rmsnorm.cu (forward, backward,
                       fused residual add)
  flash_attention.py   wrappers of csrc/flash_attention.cu (forward, backward)
  decode_attention.py  wrappers of csrc/decode_attention.cu
  mamba_scan.py        wrapper of csrc/mamba_scan.cu (Mamba2 SSD scan)
  ops.py               impl dispatch + XFA static costs
"""
