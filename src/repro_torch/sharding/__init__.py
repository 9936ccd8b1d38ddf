"""Sharding of the port over several cards: the cohort axis
(``sharding.cohort``), the ``(data, model)`` mesh (``sharding.mesh``) and
the model axis's rules (``sharding.specs``)."""
from repro_torch.sharding.cohort import (CohortMesh, CohortSharding,
                                         cohort_axis_sharding, cohort_mesh,
                                         effective_cohort_shards,
                                         init_cohort_group, shard_cohort,
                                         spawn_cohort)
from repro_torch.sharding.mesh import HostMesh, make_host_mesh
from repro_torch.sharding.specs import (batch_axes, cache_shardings,
                                        input_shardings, param_spec,
                                        params_shardings, shard_params)

__all__ = ["CohortMesh", "CohortSharding", "HostMesh", "batch_axes",
           "cache_shardings", "cohort_axis_sharding", "cohort_mesh",
           "effective_cohort_shards", "make_host_mesh", "init_cohort_group",
           "input_shardings", "param_spec", "params_shardings",
           "shard_cohort", "shard_params", "spawn_cohort"]
