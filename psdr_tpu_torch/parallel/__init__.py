from .launch import free_port, run_ranks
from .sharding import (DeviceMesh, device_mesh, initialize_distributed,
                       make_multiview_train_step, make_train_step,
                       reduce_gradients, replicate_scene_params,
                       shard_render_fn)
