"""Sharding rules of the port (`repro.sharding`'s counterpart): the logical
axis rules (`rules`), the path-name rules of parameter and decode-cache
specs (`auto`), and the placement of a step's arguments by those specs as
DTensors (`place`)."""
from repro_torch.sharding.rules import (LOGICAL_RULES, active_mesh,
                                        axis_sizes, guarded_spec,
                                        logical_to_spec, param_spec_fn,
                                        replicate, shard, use_rules)

__all__ = ["LOGICAL_RULES", "active_mesh", "axis_sizes", "guarded_spec",
           "logical_to_spec", "param_spec_fn", "replicate", "shard",
           "use_rules"]
