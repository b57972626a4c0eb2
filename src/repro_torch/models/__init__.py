"""Dense decoder model: config, layers, block, per-layer registry."""
