"""Host-side IO: checkpoints and streaming video (copies of the JAX engine's
``io/`` modules the port needs)."""
