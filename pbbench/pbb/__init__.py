"""The benchmark's own code: manifest, traffic, weights, the serving
loop, the device trace's reduction, the correctness check and the
yardstick's frozen arithmetic (percentiles, kernel costs, H100 peaks).

Nothing here imports ``jax`` or the JAX package; the program under test,
``repro_torch``, is imported only by ``pbb.serve`` (the system under
test) and never by ``reference/``.
"""
