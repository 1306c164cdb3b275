"""The develop pipeline on PyTorch tensors: plain chain on the CPU, the
hand-written CUDA kernels on the GPU."""
