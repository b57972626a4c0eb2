"""Elastic executor: VirtualCluster, flat-state backbone, ring snapshots."""
