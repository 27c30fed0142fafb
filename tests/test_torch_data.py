"""The port's host data layer against the JAX package's, on the CPU: NIfTI
IO, the ADNI index, the synthetic ADNI tree, the native decoder,
`spatial_pad`, `VolumeSource`, `Loader` and `pad_batch`. Everything here is
host numpy (or a bfloat16 CPU tensor) and must agree bit for bit; the
bfloat16 cache is compared through int16 views against JAX's uint16 views.
"""

import csv
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu.data import adni as j_adni
from transmf_ad_tpu.data import nifti as j_nifti
from transmf_ad_tpu.data import pipeline as j_pipeline
from transmf_ad_tpu.data import synthetic as j_synthetic
from transmf_ad_tpu.data import transforms as j_transforms
from transmf_ad_tpu_torch._build import BUILD_DIR
from transmf_ad_tpu_torch.data import adni, native_loader, nifti, pipeline
from transmf_ad_tpu_torch.data import synthetic, transforms

# the cache dtypes of both packages: numpy's, and bfloat16 as each holds it
DTYPES = {"float32": (np.float32, np.float32),
          "uint8": (np.uint8, np.uint8),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(v):
    """an array's bits for an exact comparison: a bfloat16 tensor (port) or
    array (JAX) as uint16, anything else as it is"""
    if isinstance(v, torch.Tensor):
        assert v.dtype == torch.bfloat16
        return v.view(torch.int16).numpy().view(np.uint16)
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype == np.dtype(jnp.bfloat16) else v


def _same_batch(port, ref):
    assert list(port) == list(ref)
    for k in ref:
        p, r = _bits(port[k]), _bits(ref[k])
        assert p.dtype == r.dtype and p.shape == r.shape, k
        np.testing.assert_array_equal(p, r, err_msg=k)


# --- NIfTI ----------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16,
                                   np.uint8])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nifti_save_load_across_packages(tmp_path, writer, dtype, suffix):
    rng = np.random.default_rng(0)
    vol = (rng.standard_normal((7, 6, 5)) * 50).astype(dtype)
    save, load = ((nifti.save, j_nifti.load) if writer == "port"
                  else (j_nifti.save, nifti.load))
    path = str(tmp_path / f"v{suffix}")
    save(path, vol, pixdim=(1.5, 2.0, 2.5))
    for out in (load(path), load(path, dtype=dtype)):
        ref = (j_nifti if writer == "jax" else nifti).load(path, dtype=out.dtype)
        np.testing.assert_array_equal(out, ref)
        assert out.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(load(path, dtype=dtype), vol)
    # the files themselves: the same bytes once gzip's header is gone
    other = str(tmp_path / f"w{suffix}")
    (j_nifti.save if writer == "port" else nifti.save)(
        other, vol, pixdim=(1.5, 2.0, 2.5))
    assert nifti._read_bytes(path) == nifti._read_bytes(other)
    hp, hj = (nifti.parse_header(nifti._read_bytes(path)),
              j_nifti.parse_header(j_nifti._read_bytes(path)))
    assert vars(hp) == vars(hj)


def test_nifti_scaling_and_big_endian(tmp_path):
    """a header with scl_slope / scl_inter, and one written big-endian"""
    import struct

    rng = np.random.default_rng(1)
    vol = rng.integers(-100, 100, (4, 5, 3)).astype(np.int16)
    path = str(tmp_path / "s.nii")
    nifti.save(path, vol)
    raw = bytearray(open(path, "rb").read())
    struct.pack_into("<2f", raw, 112, 0.5, 3.0)
    open(path, "wb").write(bytes(raw))
    np.testing.assert_array_equal(nifti.load(path), j_nifti.load(path))
    np.testing.assert_array_equal(nifti.load(path), vol * 0.5 + 3.0)
    # the same volume big-endian: header fields and voxels swapped
    big = bytearray(raw)
    struct.pack_into(">i", big, 0, 348)
    struct.pack_into(">8h", big, 40, 3, 4, 5, 3, 1, 1, 1, 1)
    struct.pack_into(">h", big, 70, 4)
    struct.pack_into(">8f", big, 76, *[1.0] * 8)
    struct.pack_into(">f", big, 108, 352.0)
    struct.pack_into(">2f", big, 112, 0.5, 3.0)
    big[352:] = np.asfortranarray(vol).astype(">i2").tobytes(order="F")
    bpath = str(tmp_path / "b.nii")
    open(bpath, "wb").write(bytes(big))
    np.testing.assert_array_equal(nifti.load(bpath), j_nifti.load(bpath))
    np.testing.assert_array_equal(nifti.load(bpath), nifti.load(path))


@pytest.mark.parametrize("raw", [
    b"short",  # truncated
    b"\x00" * 348,  # bad sizeof_hdr
    (348).to_bytes(4, "little") + b"\x00" * 340 + b"xx1\x00",  # bad magic
    (348).to_bytes(4, "little") + b"\x00" * 36 + (0).to_bytes(2, "little")
    + b"\x00" * 302 + b"n+1\x00",  # ndim 0
    (348).to_bytes(4, "little") + b"\x00" * 36 + (3).to_bytes(2, "little")
    + b"\x00" * 28 + (7).to_bytes(2, "little") + b"\x00" * 272
    + b"n+1\x00",  # datatype 7 does not exist
])
def test_nifti_rejects_garbage(tmp_path, raw):
    path = str(tmp_path / "bad.nii")
    open(path, "wb").write(raw)
    msgs = []
    for mod in (nifti, j_nifti):
        with pytest.raises(ValueError) as err:
            mod.load(path)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --- the ADNI index and the synthetic tree --------------------------------

@pytest.mark.parametrize("task", sorted(adni.TASK_LABELS))
def test_adni_index(adni_root, task):
    port, ref = adni.ADNI(adni_root, task=task), j_adni.ADNI(adni_root,
                                                             task=task)
    assert port.data_dict == ref.data_dict
    assert port.class_counts() == ref.class_counts()
    assert adni.TASK_LABELS == j_adni.TASK_LABELS


def test_adni_unknown_task(adni_root):
    with pytest.raises(ValueError, match="unknown task"):
        adni.ADNI(adni_root, task="XY")


def test_make_synthetic_adni_same_tree(tmp_path):
    kw = dict(n_per_group=2, shape=(9, 11, 7), seed=3)
    port = synthetic.make_synthetic_adni(str(tmp_path / "p"), **kw)
    ref = j_synthetic.make_synthetic_adni(str(tmp_path / "j"), **kw)
    rows = [list(csv.reader(open(os.path.join(r, "ADNI.csv"))))
            for r in (port, ref)]
    assert rows[0] == rows[1] and len(rows[0]) == 1 + 4 * 2
    for mod in ("MRI", "PET"):
        names = sorted(os.listdir(os.path.join(ref, mod)))
        assert sorted(os.listdir(os.path.join(port, mod))) == names
        for name in names:
            np.testing.assert_array_equal(
                nifti.load(os.path.join(port, mod, name)),
                j_nifti.load(os.path.join(ref, mod, name)))


# --- the native decoder ---------------------------------------------------

def test_native_loader_builds_into_the_port(adni_root):
    """g++ is on this host: the port builds the repository's decoder into
    its own build directory (the JAX package's `native/` is left alone)"""
    assert native_loader.available()
    lib = Path(native_loader._lib._name)
    assert lib.parent == BUILD_DIR and lib.name.startswith("libnifti_loader_")


@pytest.mark.parametrize("normalize", [False, True])
def test_native_decode_matches_python(adni_root, normalize):
    recs = adni.ADNI(adni_root, task="ADCN").data_dict
    paths = [r["MRI"] for r in recs[:4]]
    shape = native_loader.peek_dims(paths[0])
    assert shape == nifti.load(paths[0]).shape
    batch = native_loader.decode_batch(paths, shape, normalize)
    for i, p in enumerate(paths):
        one = native_loader.decode(p, shape, normalize)
        py = native_loader._py_decode(p, shape, normalize)
        np.testing.assert_array_equal(batch[i], one)
        np.testing.assert_allclose(one, py, atol=1e-5 if normalize else 0)


def test_native_bad_path_raises(tmp_path):
    with pytest.raises(ValueError):
        native_loader.decode(str(tmp_path / "missing.nii.gz"), (4, 4, 4))


# --- spatial_pad ----------------------------------------------------------

@pytest.mark.parametrize("shape,target", [
    ((5, 6, 7), (8, 8, 8)),  # odd differences: the extra voxel trails
    ((5, 6, 7), (5, 9, 4)),  # one axis wider, one narrower (no crop)
    ((4, 4, 4), (4, 4, 4)),  # nothing to do: the same object back
])
def test_spatial_pad(shape, target):
    vol = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ref = j_transforms.spatial_pad(vol, target)
    out = transforms.spatial_pad(vol, target)
    np.testing.assert_array_equal(out, ref)
    t = transforms.spatial_pad(torch.from_numpy(vol), target)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), ref)
    if shape == target:
        assert out is vol


# --- VolumeSource, Loader, pad_batch --------------------------------------

def _sources(root, dtype, **kw):
    recs = j_adni.ADNI(root, task="ADCN").data_dict
    port_dt, jax_dt = DTYPES[dtype]
    return (pipeline.VolumeSource(recs, dtype=port_dt, **kw),
            j_pipeline.VolumeSource(recs, dtype=jax_dt, **kw))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("pad_to", [None, (26, 29, 27)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_volume_source_items(adni_root, dtype, pad_to, use_native):
    port, ref = _sources(adni_root, dtype, pad_to=pad_to,
                         use_native=use_native)
    for i in (0, 3, len(ref) - 1):
        _same_batch(port[i], ref[i])
        if dtype == "bfloat16":
            assert port[i]["MRI"].dtype == torch.bfloat16
    # the batched decode (the native pool for cache misses) and the cache
    port2, ref2 = _sources(adni_root, dtype, pad_to=pad_to,
                           use_native=use_native)
    for p, r in zip(port2.get_batch([5, 1, 2]), ref2.get_batch([5, 1, 2])):
        _same_batch(p, r)
    assert port2[1] is port2.get_batch([1])[0]


def test_volume_source_uint8_needs_normalize(adni_root):
    recs = adni.ADNI(adni_root, task="ADCN").data_dict
    with pytest.raises(ValueError, match="normalize"):
        pipeline.VolumeSource(recs, dtype=np.uint8, normalize=False)


def _flip_mri(item):
    """a host sample transform that builds a new item"""
    out = dict(item)
    v = item["MRI"]
    out["MRI"] = (v.flip(0) if isinstance(v, torch.Tensor)
                  else np.ascontiguousarray(v[::-1]))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch,shuffle,drop_last,transform", [
    (3, True, False, False), (3, True, True, False),
    (3, False, False, True), (2, True, False, True),
])
def test_loader_two_epochs(adni_root, dtype, batch, shuffle, drop_last,
                           transform):
    port_src, ref_src = _sources(adni_root, dtype)
    kw = dict(indices=[6, 0, 3, 5, 1, 7, 2], batch_size=batch,
              shuffle=shuffle, drop_last=drop_last, seed=4,
              sample_transform=_flip_mri if transform else None)
    port = pipeline.Loader(port_src, **kw)
    ref = j_pipeline.Loader(ref_src, **kw)
    assert len(port) == len(ref)
    _same_batch(port.peek(), ref.peek())
    for _ in range(2):  # the shuffle differs per epoch, the same on both
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(ref)
        for p, r in zip(got, want):
            _same_batch(p, r)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,pad_to", [(3, 3), (2, 6), (1, 4)])
def test_pad_batch(adni_root, dtype, n, pad_to):
    port_src, ref_src = _sources(adni_root, dtype)
    port = next(iter(pipeline.Loader(port_src, batch_size=n)))
    ref = next(iter(j_pipeline.Loader(ref_src, batch_size=n)))
    out, want = pipeline.pad_batch(port, pad_to), j_pipeline.pad_batch(ref,
                                                                       pad_to)
    _same_batch(out, want)
    assert out["mask"].tolist() == [1.0] * n + [0.0] * (pad_to - n)
