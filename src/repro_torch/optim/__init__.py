"""AdamW: tree-level (the whole-model launcher) and flat-vector (the
VirtualCluster's ZeRO-1 shards)."""
