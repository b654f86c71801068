# The Phase-2 kernels, each in its own directory: ref.py (the plain PyTorch
# version), ops.py (the public wrapper: a CPU tensor takes ref.py, a CUDA
# tensor launches the kernel), kernel.py (the ctypes binding of the CUDA
# source under csrc/).  _build.py compiles and loads csrc/ at first use.
