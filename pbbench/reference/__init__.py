"""Plain PyTorch references of the configurations the benchmark runs.

A configuration's file names its reference module (``"reference"``).  A
reference imports nothing of the program, of the JAX package, of ``jax``
or of the harness (``pbb``): it reads the weights and LoRA factors the
benchmark made, works out the merged weights again itself, and judges the
tokens the program served.

A configuration is data plus its reference module, and the module is the
model's whole contract with the harness.  The correctness check calls:

* ``final_hidden(m, params, seqs, lora=None, control=False)``: the final
  normed hidden states of each (tokens, prompt length), in float32, or
  computed in the control's lower precision;
* ``top_tokens(m, params, hidden, control)``: the token each position's
  logits put first;
* ``gaps(m, params, hidden, picks)``: by how much each picked token's
  logit lies below the best;
* ``no_tf32()``: a context in which float32 products stay float32.

A module whose model is not the default attention stack (``decoder.py``'s:
``n_layers`` layers of attention, each followed by a dense MLP or a
mixture of experts) also states what follows from its layer structure,
as ``pbb/manifest.py`` sets out: ``leaf_specs(m)`` (its weight layout,
each leaf with its init and, where it is not the serving dtype, its
dtype), ``decode_step_cost(m, n_live, cached_rows, routed_read)`` (what
one decode step needs at least) and ``attn_layers(m)`` (the layers that
attend and hold K/V).  ``decoder.py`` defines none of the three.
"""
