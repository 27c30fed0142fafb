"""The port's feeds to the device against the JAX package's, on the CPU.

`DeviceFeed` (through `device_prefetch`), `DeviceCachedFeed` and
`HybridCachedFeed` of the port, with CPU tensors, against the same feeds of
the JAX package over the same synthetic ADNI tree: two epochs with shuffle,
a ragged last batch padded to a fixed size (wrap-around duplicates and a
mask), in float32, uint8 and bfloat16. Every batch of both packages agrees
bit for bit: volumes (bfloat16 through uint16 views: the port's
`torch.bfloat16` tensors against JAX's), labels, masks and the real count
'_n_real'. Also `cache_bytes` against JAX's, the budget's override, and the
cached feeds refusing a host `sample_transform`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu.data import device_cache as j_cache
from transmf_ad_tpu.data import pipeline as j_pipeline
from transmf_ad_tpu.data.adni import ADNI as J_ADNI
from transmf_ad_tpu_torch.data import (ADNI, DeviceCachedFeed, DeviceFeed,
                                       HybridCachedFeed, Loader,
                                       VolumeSource, cache_bytes,
                                       device_prefetch, fits_budget,
                                       hbm_budget, pad_batch)

BATCH = 3  # 8 ADCN pairs: 3, 3 and a ragged 2
DTYPES = {"float32": (np.float32, np.float32),
          "uint8": (np.uint8, np.uint8),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(v):
    """An array's bits for an exact comparison: a bfloat16 tensor (port) or
    array (JAX) as uint16, anything else as it is."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype == np.dtype(jnp.bfloat16) else v


def _loaders(adni_root, dtype, shuffle=True, drop_last=False, seed=7):
    port_dt, jax_dt = DTYPES[dtype]
    port = Loader(VolumeSource(ADNI(adni_root, task="ADCN").data_dict,
                               dtype=port_dt),
                  batch_size=BATCH, shuffle=shuffle, drop_last=drop_last,
                  seed=seed)
    ref = j_pipeline.Loader(
        j_pipeline.VolumeSource(J_ADNI(adni_root, "ADNI.csv",
                                       "ADCN").data_dict, dtype=jax_dt),
        batch_size=BATCH, shuffle=shuffle, drop_last=drop_last, seed=seed)
    return port, ref


def _assert_same(port_batches, ref_batches, n_real=True):
    assert len(port_batches) == len(ref_batches)
    for pb, rb in zip(port_batches, ref_batches):
        keys = ("MRI", "PET", "label", "mask")
        for k in keys:
            p = pb[k]
            assert isinstance(p, torch.Tensor) and p.device.type == "cpu", k
            np.testing.assert_array_equal(_bits(p), _bits(rb[k]), err_msg=k)
            assert _bits(p).dtype == _bits(rb[k]).dtype, k
        if n_real:
            assert pb["_n_real"] == rb["_n_real"]
            assert isinstance(pb["_n_real"], int)


def _epochs(feed, n=2):
    return [list(feed) for _ in range(n)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_device_feed(adni_root, dtype):
    port, ref = _loaders(adni_root, dtype)
    got = _epochs(DeviceFeed(port, "cpu", depth=2, pad_to=BATCH))
    want = _epochs(j_pipeline.DeviceFeed(ref, depth=2, pad_to=BATCH))
    for p, r in zip(got, want):
        _assert_same(p, r)
    assert [b["_n_real"] for b in got[0]] == [3, 3, 2]
    assert got[0][-1]["mask"].tolist() == [1.0, 1.0, 0.0]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_device_cached_feed(adni_root, dtype):
    port, ref = _loaders(adni_root, dtype)
    feed = DeviceCachedFeed(port, "cpu", pad_to=BATCH)
    assert feed.device_resident and len(feed) == 3
    got = _epochs(feed)
    store = feed._store
    want = _epochs(j_cache.DeviceCachedFeed(ref, mesh=None, pad_to=BATCH))
    for p, r in zip(got, want):
        _assert_same(p, r)
    assert feed._store is store  # one fill


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hot_rows", [0, 3, 100])
def test_hybrid_cached_feed(adni_root, dtype, hot_rows):
    port, ref = _loaders(adni_root, dtype)
    row = cache_bytes(port) // len(port.indices)
    feed = HybridCachedFeed(port, "cpu", pad_to=BATCH, budget=hot_rows * row)
    jfeed = j_cache.HybridCachedFeed(ref, pad_to=BATCH,
                                     budget=hot_rows * row)
    assert feed.n_hot == jfeed.n_hot == min(hot_rows, 8)
    assert feed.hot_fraction == jfeed.hot_fraction
    for p, r in zip(_epochs(feed), _epochs(jfeed)):
        _assert_same(p, r)


def test_feeds_agree_with_the_host_path(adni_root):
    """The port's four ways to one epoch agree: Loader + pad_batch on the
    host, DeviceFeed, DeviceCachedFeed and HybridCachedFeed."""
    loaders = [_loaders(adni_root, "bfloat16")[0] for _ in range(4)]
    row = cache_bytes(loaders[0]) // 8
    host = [dict(pad_batch(b, BATCH), _n_real=int(b["label"].shape[0]))
            for b in loaders[0]]
    host = [{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in b.items()} for b in host]
    for feed in (DeviceFeed(loaders[1], "cpu", pad_to=BATCH),
                 DeviceCachedFeed(loaders[2], "cpu"),
                 HybridCachedFeed(loaders[3], "cpu", budget=4 * row)):
        _assert_same(list(feed), host)


def test_device_prefetch_order_and_metadata():
    """`depth` batches ahead, in order, '_n_real' carried as it is, numpy
    values turned into tensors and tensors kept (bfloat16 included)."""
    pulled = []

    def batches():
        for i in range(5):
            pulled.append(i)
            yield {"x": np.full(2, i, np.int32),
                   "v": torch.full((2,), float(i), dtype=torch.bfloat16),
                   "_n_real": i}

    it = device_prefetch(batches(), "cpu", depth=2)
    first = next(it)
    assert pulled == [0, 1, 2]  # two ahead of the one handed out
    rest = list(it)
    for i, b in enumerate([first, *rest]):
        assert b["_n_real"] == i
        assert b["x"].tolist() == [i, i] and b["x"].dtype == torch.int32
        assert b["v"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cache_bytes(adni_root, dtype):
    port, ref = _loaders(adni_root, dtype)
    assert cache_bytes(port) == j_cache.cache_bytes(ref, None)
    itemsize = {"float32": 4, "uint8": 1, "bfloat16": 2}[dtype]
    assert cache_bytes(port) == 8 * 2 * 24 * 28 * 24 * itemsize


def test_budget(adni_root, monkeypatch):
    port, _ = _loaders(adni_root, "float32")
    monkeypatch.delenv("TRANSMF_CACHE_BUDGET_MB", raising=False)
    assert hbm_budget("cpu") == 6 * 2**30
    monkeypatch.setenv("TRANSMF_CACHE_BUDGET_MB", "0.5")
    assert hbm_budget("cpu") == j_cache.hbm_budget() == 2**19
    assert not fits_budget(port, device="cpu")  # 1.03 MB
    monkeypatch.setenv("TRANSMF_CACHE_BUDGET_MB", "2")
    assert fits_budget(port, device="cpu")
    assert fits_budget(port, budget=cache_bytes(port))
    assert not fits_budget(port, budget=cache_bytes(port) - 1)


def test_cached_feeds_refuse_sample_transform(adni_root):
    port, _ = _loaders(adni_root, "float32")
    port.sample_transform = lambda it: it
    for feed in (DeviceCachedFeed, HybridCachedFeed):
        with pytest.raises(ValueError, match="sample_transform"):
            feed(port, "cpu")
