"""Multi-device rendering over ``torch.distributed`` (``shard.py``) and the
multi-device dry run (``dryrun.py``)."""
from photon_tpu_torch.parallel.shard import (  # noqa: F401
    make_mesh,
    multihost_init,
    pad_to_multiple,
    scaling_report,
)
