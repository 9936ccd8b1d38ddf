"""Sharding of the port over several cards: the cohort axis
(``sharding.cohort``)."""
from repro_torch.sharding.cohort import (CohortMesh, CohortSharding,
                                         cohort_axis_sharding, cohort_mesh,
                                         effective_cohort_shards,
                                         init_cohort_group, shard_cohort,
                                         spawn_cohort)

__all__ = ["CohortMesh", "CohortSharding", "cohort_axis_sharding",
           "cohort_mesh", "effective_cohort_shards", "init_cohort_group",
           "shard_cohort", "spawn_cohort"]
