from repro_torch.sharding.rules import (batch_axes, batch_spec, cache_specs,
                                        distribute_tree, param_specs, placements,
                                        MeshInfo, PartitionSpec)

__all__ = ["batch_axes", "batch_spec", "cache_specs", "distribute_tree",
           "param_specs", "placements", "MeshInfo", "PartitionSpec"]
