"""Ring snapshots to host memory."""
