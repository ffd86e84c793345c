"""Device kernels (counterparts of lighthouse_tpu/ops): each module holds a
kernel's wrappers, its plain PyTorch version, its launch counts and the
loader of its CUDA source in ``../csrc``."""
