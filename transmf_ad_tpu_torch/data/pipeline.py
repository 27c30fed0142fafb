"""Data pipeline: decode -> cache -> batch -> device.

Port of transmf_ad_tpu/data/pipeline.py, with the same behaviour:

 - decoded, intensity-normalised volumes are cached in host RAM after the
   first epoch (`VolumeSource`), decoding cache misses of a batch through
   the native worker pool (`data/native_loader.py`);
 - batches are assembled by a background thread into a bounded queue
   (`Loader`), overlapping host work with device steps;
 - a ragged last batch is padded to a fixed size with a validity mask
   (`pad_batch`);
 - batches move to the device `depth` steps ahead of their use
   (`device_prefetch`, `DeviceFeed`): on a CUDA device through pinned host
   memory and asynchronous copies on a side stream, so a copy overlaps the
   step before it.

The bfloat16 cache holds `torch.bfloat16` CPU tensors, not numpy arrays:
numpy has no bfloat16 without ml_dtypes, which the port does not rely on.
The cast rounds to nearest even, as ml_dtypes' does, so the bits are the
JAX package's (a test compares them through int16 views). The train and
eval steps take such a batch as it is. Random augmentations are not applied
here: they run on the device inside the train step.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import nifti
from .transforms import spatial_pad

VOLUME_KEYS = ("MRI", "PET")


def _minmax(vol: np.ndarray) -> np.ndarray:
    lo, hi = float(vol.min()), float(vol.max())
    if hi <= lo:
        return np.zeros_like(vol)
    return (vol - lo) / (hi - lo)


class VolumeSource:
    """Decodes ADNI records to normalised volumes, with a RAM cache.

    `dtype` is the cache and transfer dtype: numpy float32 (default), numpy
    uint8, or `torch.bfloat16`. Decode and min-max normalisation always run
    in float32; the cast happens once, when the cache is filled.
    `torch.bfloat16` keeps each volume as a bfloat16 CPU tensor, half the
    bytes of float32. `np.uint8` quantizes the [0, 1]-normalised volume to
    q = round(255 * x) (requires `normalize=True`); the steps dequantize on
    the device (`train.steps.dequantize_input`).
    """

    def __init__(
        self,
        records: Sequence[Dict],
        keys: Sequence[str] = VOLUME_KEYS,
        pad_to: Optional[tuple] = None,
        normalize: bool = True,
        cache: bool = True,
        use_native: Optional[bool] = None,
        dtype=np.float32,
    ):
        self.records = list(records)
        self.keys = tuple(keys)
        self.pad_to = pad_to
        self.normalize = normalize
        self.dtype = dtype if dtype is torch.bfloat16 else np.dtype(dtype)
        if self.dtype == np.uint8 and not normalize:
            raise ValueError(
                "dtype=uint8 quantizes the [0,1]-normalized volume; "
                "it requires normalize=True")
        self._cache: Optional[List] = ([None] * len(self.records) if cache
                                       else None)
        self._lock = threading.Lock()
        if use_native is None:
            from . import native_loader

            use_native = native_loader.available()
        self.use_native = use_native

    def __len__(self):
        return len(self.records)

    def _decode_vol(self, path: str) -> np.ndarray:
        if self.use_native:
            from . import native_loader

            shape = native_loader.peek_dims(path)
            return native_loader.decode(path, shape, self.normalize)
        vol = nifti.load(path, dtype=np.float32)
        return _minmax(vol) if self.normalize else vol

    def _finalize(self, vol: np.ndarray):
        if self.pad_to is not None:
            vol = spatial_pad(vol, self.pad_to)
        if self.dtype is torch.bfloat16:
            return torch.from_numpy(np.ascontiguousarray(vol)).to(
                torch.bfloat16)
        if vol.dtype != self.dtype:
            if self.dtype == np.uint8:  # quantize the normalized volume
                vol = (vol * 255.0 + 0.5).astype(np.uint8)
            else:
                vol = vol.astype(self.dtype)
        return vol

    def _decode(self, rec: Dict) -> Dict:
        out = {"label": np.int32(rec["label"])}
        for k in self.keys:
            out[k] = self._finalize(self._decode_vol(rec[k]))
        return out

    def __getitem__(self, i: int) -> Dict:
        if self._cache is None:
            return self._decode(self.records[i])
        item = self._cache[i]
        if item is None:
            item = self._decode(self.records[i])
            with self._lock:
                self._cache[i] = item
        return item

    def get_batch(self, idx: Sequence[int]) -> List[Dict]:
        """Fetch a batch, decoding cache misses through the C++ worker pool
        (`native_loader.decode_batch`) when all missing volumes of a key
        share one shape; mixed shapes fall back to per-volume decode."""
        idx = [int(i) for i in idx]
        missing = [
            i for i in idx
            if self._cache is None or self._cache[i] is None
        ]
        decoded: Dict[int, Dict] = {}
        if self.use_native and len(missing) > 1:
            from . import native_loader

            decoded = {i: {"label": np.int32(self.records[i]["label"])}
                       for i in missing}
            complete = True

            for k in self.keys:
                paths = [self.records[i][k] for i in missing]
                dims = {native_loader.peek_dims(p) for p in paths}
                if len(dims) != 1:
                    complete = False
                    break
                vols = native_loader.decode_batch(paths, dims.pop(),
                                                  self.normalize)
                for j, i in enumerate(missing):
                    decoded[i][k] = self._finalize(vols[j])
            if not complete:
                decoded = {}
            elif self._cache is not None:
                with self._lock:
                    for i in missing:
                        self._cache[i] = decoded[i]
        return [decoded[i] if i in decoded else self[i] for i in idx]


class Loader:
    """Iterable over stacked batches with background prefetch.

    Matches the reference loader's semantics (batch, shuffle, drop_last);
    a worker thread overlaps decode and stacking with compute. Volumes are
    stacked into numpy arrays, or into one bfloat16 tensor from a bfloat16
    source; labels into int32 arrays. The shuffle draws from
    `np.random.default_rng(seed)`, one permutation an epoch, as the JAX
    package's does.
    """

    def __init__(
        self,
        source: VolumeSource,
        indices: Optional[Sequence[int]] = None,
        batch_size: int = 2,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        sample_transform=None,
    ):
        self.source = source
        self.indices = np.asarray(
            indices if indices is not None else np.arange(len(source)),
            dtype=np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        # host-side per-sample transform; applied after decode/cache, never
        # mutates cached items, skipped by `peek` (shape probing only)
        self.sample_transform = sample_transform
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.indices)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _batches(self) -> Iterator[np.ndarray]:
        order = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        n = len(order)
        stop = ((n // self.batch_size) * self.batch_size if self.drop_last
                else n)
        for s in range(0, stop, self.batch_size):
            yield order[s: s + self.batch_size]

    def peek(self) -> Dict:
        """A representative batch, assembled synchronously (for shape
        probing / model init); does not disturb the shuffle RNG."""
        idx = self.indices[: self.batch_size]
        return self._stack([self.source[int(i)] for i in idx])

    @staticmethod
    def _stack(items: List[Dict]) -> Dict:
        batch = {}
        for k in items[0]:
            values = [it[k] for it in items]
            batch[k] = (torch.stack(values)
                        if isinstance(values[0], torch.Tensor)
                        else np.stack(values))
        return batch

    def __iter__(self) -> Iterator[Dict]:
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()

        def worker():
            try:
                for idx in self._batches():
                    items = (self.source.get_batch(idx)
                             if hasattr(self.source, "get_batch")
                             else [self.source[int(i)] for i in idx])
                    if self.sample_transform is not None:
                        items = [self.sample_transform(it) for it in items]
                    q.put(self._stack(items))
                q.put(done)
            except BaseException as e:  # surface decode errors in the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def pad_batch(batch: Dict, pad_to: int) -> Dict:
    """Pad a ragged batch to a fixed leading size and attach a float32
    validity mask (1 for the real samples, then 0).

    Short batches are padded by repeating real samples (wrap-around) rather
    than zeros: the masked loss and metrics ignore the duplicates, and
    BatchNorm batch statistics, which see the whole batch, average over real
    volumes. numpy arrays stay numpy arrays and tensors stay tensors.
    """
    n = batch["label"].shape[0]
    mask = np.zeros(pad_to, np.float32)
    mask[:n] = 1.0
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
        if n < pad_to:
            reps = np.arange(pad_to - n) % n
            if isinstance(v, torch.Tensor):
                v = torch.cat([v, v[torch.from_numpy(reps)]])
            else:
                v = np.concatenate([v, np.take(v, reps, axis=0)])
        out[k] = v
    out["mask"] = mask
    return out


def _to_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


def device_prefetch(batches: Iterable[Dict], device="cuda", depth: int = 2):
    """Move batches (dicts of numpy arrays or CPU tensors) to `device`
    `depth` batches ahead of their use; yields dicts of tensors.

    On a CUDA device each value is staged in pinned host memory and copied
    with `non_blocking=True` on a side stream; the consumer's stream waits
    on the copy's event before it gets the batch, and each device tensor is
    marked as used by the consumer's stream (`record_stream`), so the
    allocator does not hand its memory out again while the step still
    reads it. The pinned buffers come from PyTorch's caching host
    allocator, which keeps a block until the copies that read it are done.
    On the CPU device the values become tensors in place, with no stream.
    A '_n_real' entry is host metadata (the real-sample count the trainer
    dispatches on): it is carried around the transfer, never moved.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None

    def put(b):
        n = b.pop("_n_real", None)
        if cuda:
            host = {k: _to_tensor(v).pin_memory() for k, v in b.items()}
            with torch.cuda.stream(side):
                out = {k: v.to(device, non_blocking=True)
                       for k, v in host.items()}
                ready = torch.cuda.Event()
                ready.record(side)
        else:
            out = {k: _to_tensor(v).to(device) for k, v in b.items()}
            ready = None
        if n is not None:
            out["_n_real"] = n
        return out, ready

    def take(entry):
        out, ready = entry
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
        return out

    buf: List = []
    it = iter(batches)
    for b in it:
        buf.append(put(b))
        if len(buf) >= depth:
            break
    for nxt in it:
        out = take(buf.pop(0))
        buf.append(put(nxt))
        yield out
    while buf:
        yield take(buf.pop(0))


class DeviceFeed:
    """Loader adapter: iteration yields batches already on `device`,
    transferred `depth` steps ahead of their use (`device_prefetch`), each
    padded to `pad_to` samples by `pad_batch` with its real count as
    '_n_real' when `pad_to` is given. Used by `Trainer.fit` as the
    streaming feed; delegates `len`/`peek` to the wrapped loader."""

    def __init__(self, loader, device="cuda", depth: int = 2,
                 pad_to: Optional[int] = None):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth
        self.pad_to = pad_to  # fixed batch size (see pad_batch)

    def __len__(self):
        return len(self.loader)

    def peek(self):
        return self.loader.peek()

    def __iter__(self):
        it = iter(self.loader)
        if self.pad_to is not None:
            def padded(it):
                for b in it:
                    n = int(b["label"].shape[0])
                    pb = pad_batch(b, self.pad_to)
                    pb["_n_real"] = n  # host metadata (see device_prefetch)
                    yield pb
            it = padded(it)
        return device_prefetch(it, self.device, self.depth)
