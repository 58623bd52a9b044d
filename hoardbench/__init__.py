"""The benchmark of the PyTorch and CUDA port (``repro_torch``): Hoard-fed
training on an H100, driven by the files under this directory.  Nothing here
imports JAX or the JAX package."""
