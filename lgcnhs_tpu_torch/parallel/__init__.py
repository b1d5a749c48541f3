from lgcnhs_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingPlan,
    distributed_masked_topk,
    make_plan,
    make_sharded_train_scan,
    make_sharded_train_step,
    padded_catalog,
    shard_params,
    shard_train_inputs,
    unpad_params,
)
