"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain
PyTorch versions.  ``build`` compiles and binds the kernels at first use;
each kernel module keeps the wrapper, its launch count and the plain
version; ``ops`` adapts the model's (B, S, H, d) layout."""
