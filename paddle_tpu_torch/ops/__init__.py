"""The port's attention, MoE routing and weight-only linear ops:
hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  A wrapper launches its kernel for CUDA tensors and takes the
plain version only for CPU tensors."""
