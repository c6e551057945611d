"""repro_torch.distributed — sharding rules and collective schedules."""

from repro_torch.distributed.sharding import (logical_axis_rules, constrain,
                                              resolve, strategy_for, param_specs,
                                              current_rules)

__all__ = ["logical_axis_rules", "constrain", "resolve", "strategy_for",
           "param_specs", "current_rules"]
