"""Multi-process tensor-parallel serving on torch.distributed.

Counterpart of rwkv_lm_ext_tpu/parallel (distributed.py and mesh.py, serving's
part): ``distributed`` joins the process group and carries the lockstep
server's messages, ``mesh`` holds the tensor-parallel group and the
head-parallel layout, ``tp`` cuts a model into a rank's part. Training's
parts (pipeline.py, sequence.py, the hybrid mesh, dp) are not ported yet
(ROADMAP A.12).
"""
from rwkv_lm_ext_tpu_torch.parallel.distributed import (  # noqa: F401
    broadcast_obj,
    init_distributed,
    is_main_process,
    process_count,
    process_index,
)
from rwkv_lm_ext_tpu_torch.parallel.mesh import Mesh, make_mesh, split_axis  # noqa: F401
from rwkv_lm_ext_tpu_torch.parallel.tp import shard_model  # noqa: F401
