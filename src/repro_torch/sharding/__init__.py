from repro_torch.sharding.constrain import (ambient_mesh, constrain,
                                            constrain_spec, use_mesh)
from repro_torch.sharding.placement import (clients_group, full_tree,
                                           local_slices, placements, shard,
                                           shard_tree)
from repro_torch.sharding.specs import (MeshShape, Spec, axis_sizes,
                                        batch_specs, cache_specs, data_axes,
                                        opt_state_specs, param_specs,
                                        tree_batch_specs)

__all__ = ["MeshShape", "Spec", "ambient_mesh", "axis_sizes",
           "batch_specs", "cache_specs", "clients_group", "constrain", "constrain_spec",
           "data_axes", "full_tree", "local_slices", "opt_state_specs",
           "param_specs", "placements", "shard", "shard_tree",
           "tree_batch_specs", "use_mesh"]
