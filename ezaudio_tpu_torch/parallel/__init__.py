"""Multi-GPU parallelism (counterpart of ``ezaudio_tpu/parallel``): the
process group, the ``(dp, fsdp, tp, sp)`` mesh and its sharding rules
(``mesh.py``, applied by ``sharding.py``), and the sequence-parallel ring
(``ring_attention.py``).  ``python -m ezaudio_tpu_torch.parallel.dryrun``
runs them end to end."""

from ezaudio_tpu_torch.parallel.mesh import (  # noqa: F401
    activation_sharding,
    constrain_batch,
    dit_param_shardings,
    gather_rows,
    init_distributed,
    make_mesh,
    param_shardings,
    replicate,
    shard_batch,
)
from ezaudio_tpu_torch.parallel.ring_attention import (  # noqa: F401
    current_ring_context,
    ring_attention,
    ring_context,
)
from ezaudio_tpu_torch.parallel.sharding import shard_params  # noqa: F401
