"""The multi-device paths (deepsir_tpu/parallel/): one process per card,
`torch.distributed` between them. Importing the package starts no process
group."""
from deepsir_tpu_torch.parallel.mesh import make_mesh
from deepsir_tpu_torch.parallel.sharded import (make_sharded_eval_step,
                                                make_sharded_train_step,
                                                model_with_mesh_matcher, replicate_state,
                                                shard_batch)
from deepsir_tpu_torch.parallel.matching import (make_ring_matcher,
                                                 ring_nearest_neighbour_index,
                                                 sharded_nearest_neighbour_index)
