"""Plain float32 references of models the port serves and the JAX package
does not have: the equations as published, in plain ``torch`` operations,
with no kernel of the port, no cache and no batching.  Tests hold the port
against them."""
