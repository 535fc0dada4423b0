"""The port's spill tier (counterpart of vega_tpu/store/): storage levels
and the on-disk block store that persisted dense nodes demote to."""

from vega_tpu_torch.store.disk import DiskStore
from vega_tpu_torch.store.level import StorageLevel

__all__ = ["DiskStore", "StorageLevel"]
