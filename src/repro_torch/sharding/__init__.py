"""Sharding rules and placements (counterpart of ``repro/sharding``)."""
from repro_torch.sharding.partitioner import (AxisPlan, PartitionSpec,  # noqa
                                              axis_sizes, batch_pspecs,
                                              cache_pspecs, gather,
                                              local_shard,
                                              opt_state_like_params,
                                              params_pspecs, plan_for,
                                              serve_batch_pspecs,
                                              to_placements)
