"""Logical-axis sharding of the port's tensors over a ``(data, model)``
mesh of ``torch.distributed`` ranks (port of ``repro/sharding``)."""

from repro_torch.sharding.rules import (INFER_RULES, INFER_RULES_MULTIPOD,
                                        TRAIN_RULES, TRAIN_RULES_MULTIPOD,
                                        MixerSplit, Sharder, head_units,
                                        leaf_index, resolve, shard_leaf,
                                        tree_shard)

__all__ = ["INFER_RULES", "INFER_RULES_MULTIPOD", "TRAIN_RULES",
           "TRAIN_RULES_MULTIPOD", "MixerSplit", "Sharder", "head_units",
           "leaf_index", "resolve", "shard_leaf", "tree_shard"]
