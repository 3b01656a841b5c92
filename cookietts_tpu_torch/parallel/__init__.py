"""Data, tensor and sequence parallelism across processes on
torch.distributed (cookietts_tpu/parallel/): :func:`initialize` joins the
group torchrun describes, :func:`make_mesh` splits it into dp x tp x sp
groups, :class:`DataParallel` holds a rank's rows of the global batch and
makes the step's reductions global, :mod:`.tp` shards the big weights over a
tp group (``--tp``), :mod:`.sp` shards the vocoders' time axis over an sp
group with halo exchanges (``--sp``)."""
from .launch import (allgather_object, global_batch_slice,  # noqa: F401
                     initialize, process_count, process_index, rank_device,
                     shutdown)
from .mesh import (SINGLE, VOCODER_TIME_AXES, DataParallel,  # noqa: F401
                   SingleProcess, batch_means, data_parallel, draw_rows,
                   make_mesh)
from .sp import HALO, SequenceParallel, reset_halo_counts  # noqa: F401
from .tp import (HIFIGAN_TP_RULES, TACOTRON2_TP_RULES,  # noqa: F401
                 WAVEGLOW_TP_RULES, Layout, Shard, TensorParallel, describe,
                 layout_of, shard_model)
