"""Ops tier: jnp reference paths, the GPU attention kernel, graph node kinds."""
