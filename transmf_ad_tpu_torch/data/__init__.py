"""Data layer of the port: NIfTI IO, the ADNI index, the synthetic ADNI
tree, the native decoder, the host pipeline (RAM cache, loader, padding),
the feeds to the device (streaming and device-cached), device-side
augmentation and the exact-MONAI host augmentation."""

from . import nifti  # noqa: F401
from .adni import ADNI, TASK_LABELS  # noqa: F401
from .device_cache import (  # noqa: F401
    DeviceCachedFeed,
    HybridCachedFeed,
    cache_bytes,
    fits_budget,
    hbm_budget,
)
from .pipeline import (  # noqa: F401
    DeviceFeed,
    Loader,
    VolumeSource,
    device_prefetch,
    pad_batch,
)
from .synthetic import make_synthetic_adni  # noqa: F401
from .transforms import AugmentConfig, scale_intensity, spatial_pad  # noqa: F401
