"""Minimal, dependency-free NIfTI-1 reader/writer (numpy only).

A copy of transmf_ad_tpu/data/nifti.py, whose behaviour it keeps bit for
bit. The reference pipeline loads `.nii.gz` volumes through MONAI's
``LoadImaged`` (reference: datasets/ADNI.py:62). This module provides the
same capability without nibabel/monai: a direct NIfTI-1 header parser + raw
voxel decode, with transparent gzip handling. A C++ fast path
(``transmf_ad_tpu_torch.data.native_loader``) reuses the same header layout
for threaded decode.

Only the NIfTI-1 single-file (`.nii` / `.nii.gz`, magic ``n+1``) layout is
supported, which is what ADNI preprocessed volumes use.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes (the ones that occur in practice).
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HEADER_SIZE = 348


@dataclass
class NiftiHeader:
    shape: tuple
    dtype: np.dtype
    vox_offset: int
    scl_slope: float
    scl_inter: float
    pixdim: tuple
    byteorder: str  # '<' or '>'


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":  # gzip magic
        raw = gzip.decompress(raw)
    return raw


def parse_header(raw: bytes) -> NiftiHeader:
    if len(raw) < HEADER_SIZE:
        raise ValueError("truncated NIfTI header")
    # sizeof_hdr doubles as an endianness probe.
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    bo = "<"
    if sizeof_hdr != HEADER_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        bo = ">"
        if sizeof_hdr != HEADER_SIZE:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic: {magic!r}")
    dim = struct.unpack_from(bo + "8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    # Squeeze trailing singleton dims (common: (x,y,z,1)).
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    (datatype,) = struct.unpack_from(bo + "h", raw, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype code {datatype}")
    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(bo + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(bo + "2f", raw, 112)
    return NiftiHeader(
        shape=shape,
        dtype=np.dtype(_DTYPES[datatype]).newbyteorder(bo),
        vox_offset=int(vox_offset) if vox_offset else HEADER_SIZE + 4,
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        pixdim=tuple(float(p) for p in pixdim[1:4]),
        byteorder=bo,
    )


def load(path: str, dtype=np.float32) -> np.ndarray:
    """Load a `.nii`/`.nii.gz` volume as a C-contiguous array of `dtype`.

    Applies NIfTI scaling (``scl_slope``/``scl_inter``) when present, like
    nibabel's ``get_fdata``. Voxel data is stored Fortran-order on disk;
    the returned array is C-contiguous with the same (x, y, z) indexing.
    """
    raw = _read_bytes(path)
    hdr = parse_header(raw)
    n = int(np.prod(hdr.shape))
    start = hdr.vox_offset
    flat = np.frombuffer(raw, dtype=hdr.dtype, count=n, offset=start)
    vol = flat.reshape(hdr.shape, order="F").astype(dtype)
    if hdr.scl_slope not in (0.0, 1.0) or (
        hdr.scl_slope == 1.0 and hdr.scl_inter != 0.0
    ):
        vol = vol * hdr.scl_slope + hdr.scl_inter
    return np.ascontiguousarray(vol)


def save(path: str, vol: np.ndarray, pixdim=(1.0, 1.0, 1.0)) -> None:
    """Write a NIfTI-1 single-file volume (gzip if path ends with .gz)."""
    vol = np.asarray(vol)
    if vol.dtype not in _DTYPE_CODES:
        vol = vol.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(vol.dtype)]
    ndim = vol.ndim
    dim = [ndim] + list(vol.shape) + [1] * (7 - ndim)
    hdr = bytearray(HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, HEADER_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *pixdim, *[0.0] * (7 - len(pixdim)))
    struct.pack_into("<f", hdr, 108, float(HEADER_SIZE + 4))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(vol).tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with opener(path, "wb") as f:
        f.write(payload)
