"""Data parallelism across processes on torch.distributed (the dp half of
cookietts_tpu/parallel/): :func:`initialize` joins the group torchrun
describes, :class:`DataParallel` holds a rank's rows of the global batch and
makes the step's reductions global. Tensor and sequence parallelism
(``--tp`` / ``--sp``) are not ported."""
from .launch import (allgather_object, global_batch_slice,  # noqa: F401
                     initialize, process_count, process_index, rank_device,
                     shutdown)
from .mesh import (SINGLE, DataParallel, SingleProcess,  # noqa: F401
                   batch_means, data_parallel, draw_rows)
