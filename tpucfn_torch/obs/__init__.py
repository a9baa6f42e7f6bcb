"""Serving-plane metric instruments, registry and tracer (copies of
the JAX package's jax-free modules)."""
