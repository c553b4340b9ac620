# repro_torch: the PyTorch/CUDA port of the JAX package ``repro`` (same
# layout: core/, kernels/, launch/).  It imports torch, never jax.
