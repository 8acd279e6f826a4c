from xclim_tpu_torch.parallel.sharding import (  # noqa: F401
    pad_to_mesh,
    shard_space,
    space_mesh,
    sharded_jit,
)
