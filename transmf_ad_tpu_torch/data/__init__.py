"""Data layer of the port: NIfTI IO, the ADNI index, the synthetic ADNI
tree, the native decoder, the host pipeline (RAM cache, loader, padding)
and device-side augmentation."""

from . import nifti  # noqa: F401
from .adni import ADNI, TASK_LABELS  # noqa: F401
from .pipeline import Loader, VolumeSource, pad_batch  # noqa: F401
from .synthetic import make_synthetic_adni  # noqa: F401
from .transforms import AugmentConfig, scale_intensity, spatial_pad  # noqa: F401
