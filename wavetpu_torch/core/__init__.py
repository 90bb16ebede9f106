"""Problem spec and flag parsing (copies of wavetpu.core, jax-free)."""
