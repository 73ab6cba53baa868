"""Plain PyTorch references of the configurations the benchmark runs.

A configuration's file names its reference module (``"reference"``).  A
reference imports nothing of the program, of the JAX package or of
``jax``: it reads the weights and LoRA factors the benchmark made, works
out the merged weights again itself, and judges the tokens the program
served.
"""
