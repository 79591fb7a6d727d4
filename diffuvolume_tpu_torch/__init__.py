"""DiffuVolume in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The package mirrors ``diffuvolume_tpu`` module by module and never imports it.
Entry points run on the first CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper takes its plain PyTorch
version, on CUDA tensors it launches its kernel or raises.
"""
