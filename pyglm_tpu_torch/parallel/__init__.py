from pyglm_tpu_torch.parallel.sharding import (
    make_mesh, glm_shardings, shard_model, make_sharded_sweep,
)
