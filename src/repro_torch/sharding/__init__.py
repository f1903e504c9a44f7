"""Logical-axis partition rules (``repro.sharding`` without ``shard_map``
and ``tree_shardings``, which build JAX objects)."""
from repro_torch.sharding.rules import (
    AxisRules,
    TRAIN_RULES,
    SERVE_RULES,
    SERVE_RULES_SMALL_BATCH,
    serve_rules,
    pod_decode_rules,
    spec_for,
    tree_specs,
    constrain,
    shard_ctx,
    no_shard_ctx,
    current_ctx,
    logical,
)

__all__ = [
    "AxisRules",
    "TRAIN_RULES",
    "SERVE_RULES",
    "SERVE_RULES_SMALL_BATCH",
    "serve_rules",
    "pod_decode_rules",
    "spec_for",
    "tree_specs",
    "constrain",
    "shard_ctx",
    "no_shard_ctx",
    "current_ctx",
    "logical",
]
