"""The port's flat-state backbone and ring snapshot against the JAX
package's: interval tables, shard-order gather/scatter, shard views, and the
batched SnapshotPool host state and CRCs, all exact."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core.fabric.snapshot import SnapshotPool as JPool  # noqa: E402
from repro.core.statespace import StageState as JStage  # noqa: E402
from repro.core.statespace import get_table as j_get_table  # noqa: E402
from repro.optim.adam import AdamConfig as JAdam  # noqa: E402
from repro_torch.core.fabric.snapshot import SnapshotPool  # noqa: E402
from repro_torch.core.statespace import StageState, get_table  # noqa: E402
from repro_torch.optim.adam import AdamConfig  # noqa: E402

COMPS = ("master", "mu", "nu")
# the last case leaves a remainder on the last rank (sizes % dp != 0)
GRID = [([16, 16, 16], 2), ([90368], 4), ([7, 13, 5], 3), ([5, 1, 11, 3], 4),
        ([64, 32], 1)]


@pytest.mark.parametrize("sizes,dp", GRID)
@pytest.mark.parametrize("kind", ["contiguous", "interleaved"])
def test_interval_table_matches_reference(sizes, dp, kind):
    t, j = get_table(kind, sizes, dp), j_get_table(kind, sizes, dp)
    for name in ("starts", "ends", "shard_sizes", "shard_offsets",
                 "entry_offsets"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.total == j.total
    for r in range(dp):
        assert t.owner_intervals(r) == j.owner_intervals(r)
    for pos in range(len(sizes)):
        assert t.layer_interval(pos) == j.layer_interval(pos)
    full = np.random.default_rng(0).standard_normal(t.total).astype(np.float32)
    flat = t.gather(torch.from_numpy(full))
    np.testing.assert_array_equal(flat.numpy(), j.gather(full))
    np.testing.assert_array_equal(t.scatter(flat).numpy(), full)
    for a, b in zip(t.split(flat), j.split(j.gather(full))):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("sizes,dp", GRID[:3])
@pytest.mark.parametrize("kind", ["contiguous", "interleaved"])
def test_stage_state_matches_reference(sizes, dp, kind):
    rs = np.random.default_rng(1)
    n = sum(sizes)
    full = {c: rs.standard_normal(n).astype(np.float32) for c in COMPS}
    ranks = list(range(dp))
    st = StageState.from_full([0] * len(sizes), sizes, kind, ranks,
                              {c: torch.from_numpy(v) for c, v in full.items()})
    js = JStage.from_full([0] * len(sizes), sizes, kind, ranks, full)
    for c in COMPS:
        np.testing.assert_array_equal(st.flat[c].numpy(), js.flat[c])
        np.testing.assert_array_equal(st.full(c).numpy(), js.full(c))
    for r in ranks:
        for c in COMPS:
            np.testing.assert_array_equal(st.shard(r)[c].numpy(),
                                          js.shard(r)[c])
            assert st.shards[r][c].data_ptr() == st.shard(r)[c].data_ptr()
    # shard views alias the flat buffer: an in-place update shows through
    st.shard(ranks[-1])["mu"].add_(1.0)
    assert float(st.flat["mu"][-1]) == full["mu"][js.table.shard_index[-1]] + 1


@pytest.mark.parametrize("compress", ["none", "bf16"])
@pytest.mark.parametrize("n", [2, 3])
def test_snapshot_pool_matches_reference(compress, n):
    rs = np.random.default_rng(2)
    shard_sizes = [rs.integers(5, 40) for _ in range(n)]
    shards = [{c: np.abs(rs.standard_normal(s)).astype(np.float32)
               for c in COMPS} for s in shard_sizes]
    pool = SnapshotPool(n, AdamConfig(), compress=compress)
    jpool = JPool(n, JAdam(), compress=compress, batched=True)
    pool.bootstrap(0, [{c: torch.from_numpy(v) for c, v in s.items()}
                       for s in shards])
    jpool.bootstrap(0, shards)
    assert pool.crc == jpool.crc
    for step in range(1, 4):
        grads = [rs.standard_normal(s).astype(np.float32) * 1e-2
                 for s in shard_sizes]
        a = pool.snapshot_step(step, grads, step)
        b = jpool.snapshot_step(step, grads, step)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for i in range(n):
            for c in COMPS:
                np.testing.assert_array_equal(pool.host[i][c],
                                              jpool.host[i][c])
        assert pool.crc == jpool.crc
        assert pool.snap_step == jpool.snap_step
    assert [pool.holder_of(j) for j in range(n)] == \
        [jpool.holder_of(j) for j in range(n)]
