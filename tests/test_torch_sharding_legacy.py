"""The port's sharded legacy engine (kmer_id_tpu_torch/parallel/sharded.py)
on gloo ranks, against the JAX package's ``ShardedClassifier`` and the
port's single-device legacy engine: grids (1, 2), (2, 1), (1, 3) and
(2, 2), the read stream through ``SampleProcessor`` (its first batch
overflows the hit list in one data shard only, so only that shard's db
group calls the replay's collective) and the engine API (finals, long
reads one at a time, each rank's ``seen`` block, ucount).  World, worker
and checks are tests/test_torch_sharding.py's; the grids run in a file of
their own so that the two files run side by side.
"""

import pytest

from tests.test_torch_sharding import case_ids, cases, check_case, grid_fixture, world  # noqa: F401

GRIDS = {  # (dp, dbp): the worker's tasks there
    (1, 2): ["legacy_sample", "legacy_engine"],
    (2, 1): ["legacy_sample", "legacy_engine"],
    (1, 3): ["legacy_sample", "legacy_engine"],
    (2, 2): ["legacy_sample"],
}

grids = grid_fixture(GRIDS)


@pytest.mark.parametrize("grid,task", cases(GRIDS), ids=case_ids(GRIDS))
def test_legacy_grid_matches_jax_and_single_device(world, grids, monkeypatch, grid, task):
    check_case(world, grids(*grid), grid, task, monkeypatch)
