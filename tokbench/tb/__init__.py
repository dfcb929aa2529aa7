"""The benchmark's own code: traffic, reference, tracing and arithmetic.

Nothing here imports JAX or the JAX package; the program under test,
``blingfire_tpu_torch``, is imported only by the loops and the tracing."""
