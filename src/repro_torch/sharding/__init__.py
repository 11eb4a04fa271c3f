from repro_torch.sharding.placement import (full_tree, local_slices,
                                           placements, shard, shard_tree)
from repro_torch.sharding.specs import (MeshShape, Spec, axis_sizes,
                                        batch_specs, cache_specs, data_axes,
                                        opt_state_specs, param_specs,
                                        tree_batch_specs)

__all__ = ["MeshShape", "Spec", "axis_sizes", "batch_specs", "cache_specs",
           "data_axes", "full_tree", "local_slices", "opt_state_specs",
           "param_specs", "placements", "shard", "shard_tree",
           "tree_batch_specs"]
