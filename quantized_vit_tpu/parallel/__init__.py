"""Mesh construction, GSPMD partition rules (DP x TP), pipeline (PP),
multi-host init and collective health checks."""

from .audit import (
    CollectiveOp,
    collective_stats,
    parse_collectives,
    summarize,
)
from .elastic import (
    elastic_restore,
    run_with_elastic_recovery,
    shrink_mesh,
)
from .collectives import (
    dp_all_reduce_grads,
    quantized_ring_all_reduce,
)
from .distributed import (
    HealthCheckError,
    HealthReport,
    assert_same_step,
    collective_health_check,
    create_hybrid_mesh,
    initialize_distributed,
)
from .partition import (
    create_mesh,
    VIT_PARTITION_RULES,
    spec_for_path,
    partition_specs,
    shard_params,
    data_sharding,
)
from .sharded_ckpt import (
    restore_sharded_checkpoint,
    save_sharded_checkpoint,
    scan_sharded_checkpoint,
)
from .pipeline import (
    gpipe_blocks,
    stack_block_params,
    unstack_block_params,
    vit_pipeline_forward,
)

__all__ = [
    "CollectiveOp",
    "collective_stats",
    "parse_collectives",
    "summarize",
    "elastic_restore",
    "run_with_elastic_recovery",
    "shrink_mesh",
    "dp_all_reduce_grads",
    "quantized_ring_all_reduce",
    "HealthCheckError",
    "HealthReport",
    "assert_same_step",
    "collective_health_check",
    "create_hybrid_mesh",
    "initialize_distributed",
    "create_mesh",
    "VIT_PARTITION_RULES",
    "spec_for_path",
    "partition_specs",
    "shard_params",
    "data_sharding",
    "restore_sharded_checkpoint",
    "save_sharded_checkpoint",
    "scan_sharded_checkpoint",
    "gpipe_blocks",
    "stack_block_params",
    "unstack_block_params",
    "vit_pipeline_forward",
]
