"""PyTorch/CUDA port of the ElasWave reproduction (``repro``).

The JAX package ``repro`` is the reference; this package never imports it
or jax.  See ``core.cluster.VirtualCluster`` for the entry point.
"""
