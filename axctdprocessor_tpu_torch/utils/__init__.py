"""Host utilities of the port (the jax-free report writer)."""
