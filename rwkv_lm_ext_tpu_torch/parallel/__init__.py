"""Multi-process serving and training on torch.distributed.

Counterpart of rwkv_lm_ext_tpu/parallel (distributed.py, mesh.py and
pipeline.py): ``distributed`` joins the process group, carries the lockstep
server's messages and holds the collectives, the hybrid (dp, tp) mesh and the
statement of the global batch; ``mesh`` holds the dp and tp groups and the
head-parallel layout; ``tp`` cuts a model into a rank's part, for serving
(``shard_model``) or training (``shard_for_training``, with differentiable
collectives); ``pipeline`` is GPipe over a pp group; ``sequence`` cuts the
time axis over an sp group (JAX's ``parallel/__init__.py`` exports its
functions too).
"""
from rwkv_lm_ext_tpu_torch.parallel.distributed import (  # noqa: F401
    broadcast_obj,
    init_distributed,
    is_main_process,
    local_batch_to_global,
    make_hybrid_mesh,
    process_count,
    process_index,
)
from rwkv_lm_ext_tpu_torch.parallel.mesh import Mesh, make_mesh, split_axis  # noqa: F401
from rwkv_lm_ext_tpu_torch.parallel.pipeline import (  # noqa: F401
    PipeMesh,
    make_pp_mesh,
    pipeline_loss,
)
from rwkv_lm_ext_tpu_torch.parallel.sequence import (  # noqa: F401
    make_sp_mesh,
    rwkv_forward_sequence_parallel,
    wkv6_sequence_parallel,
)
from rwkv_lm_ext_tpu_torch.parallel.tp import shard_for_training, shard_model  # noqa: F401
