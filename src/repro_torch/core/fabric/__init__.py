"""Ring snapshots to host memory, and live remap of optimizer state."""
from .snapshot import SnapshotPool
from .remap import LiveRemap, RemapPlan, IntegrityError
