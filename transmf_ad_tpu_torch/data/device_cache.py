"""Device-resident dataset cache: no host-to-device volume bytes per epoch.

Port of transmf_ad_tpu/data/device_cache.py. The reference
re-decodes every NIfTI from disk every epoch (reference:
datasets/__init__.py:56-58, num_workers=0); the host pipeline caches the
decoded volumes in RAM, but a streamed batch still crosses the
host-to-device link every epoch. A bfloat16 volume at 91x109x91 is ~1.8
MB, so an ADNI-scale dataset (~10^3 volumes x 2 modalities, ~3.6 GB) fits
in the card's memory beside the model's state.

`DeviceCachedFeed` wraps a host `Loader`:

 - The first iteration copies each volume to the device once, stacking
   each modality into one (N, X, Y, Z) tensor.
 - Every batch is then gathered on the device (`index_select` over the
   leading axis): per step the host ships only the row ids.
 - The batch order is the host path's, bit for bit: the wrapped Loader's
   own `_batches()` drives the epoch (same shuffle RNG, drop_last, seed),
   and a ragged last batch is padded with wrap-around duplicates and a
   validity mask, as `pipeline.pad_batch` pads it.
 - A dataset over the budget (`fits_budget`) is left to the streaming
   `pipeline.DeviceFeed` or to `HybridCachedFeed`, which keeps as many
   rows resident as fit and streams the rest.

Augmentation composes unchanged: it runs inside the train step on whatever
batch arrives.

Under a process group of W ranks (data parallel; the JAX package's cache
sharded over the mesh's 'data' axis) the store is row-sharded: with the
set padded to n_pad rows (a multiple of W), rank r holds rows
[r n_pad / W, (r + 1) n_pad / W) and `cache_bytes` counts those alone, so
the choice of feed is JAX's. Each step every rank knows the whole global
batch (the loaders agree), so each sends the rows it owns to the ranks whose
slice of the batch needs them, in one `all_to_all_single` a modality, and
puts what it receives in place: copies only, never a sum of zero-padded
contributions (-0.0 + 0.0 is +0.0), so the batch is bit for bit the host
path's. Labels, 4 bytes a row, are on every rank. `HybridCachedFeed` stays
single-process, as the JAX package's `Trainer.fit` gates it. With a
tensor-parallel 'model' axis the group is the data group: the ranks of one
model group hold the same rows.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..parallel.mesh import padded_batch
from .pipeline import device_prefetch

__all__ = ["DeviceCachedFeed", "HybridCachedFeed", "fits_budget",
           "cache_bytes", "hbm_budget"]

CPU_BUDGET = 6 * 2**30  # the JAX package's budget on a backend with no stats
DEPTH = 2  # batches HybridCachedFeed's cold-row worker and copy run ahead


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _vol_shape(loader):
    """Shape, itemsize and key count of one cached volume (decodes one
    row; the decode lands in the VolumeSource RAM cache, so nothing is
    wasted)."""
    src = loader.source
    first = src[int(loader.indices[0])]
    k = src.keys[0]
    itemsize = torch.empty(0, dtype=_torch_dtype(src.dtype)).element_size()
    return tuple(first[k].shape), itemsize, len(src.keys)


def cache_bytes(loader, world: int = 1) -> int:
    """Device bytes the cache for `loader` would occupy on each of `world`
    ranks (n_pad / world rows each)."""
    shape, itemsize, n_keys = _vol_shape(loader)
    rows = padded_batch(len(loader.indices), world) // world
    return rows * int(np.prod(shape)) * itemsize * n_keys


def hbm_budget(device="cuda") -> int:
    """Byte budget for dataset caching on `device`.

    TRANSMF_CACHE_BUDGET_MB overrides. Default: 40% of the card's memory
    (`torch.cuda.mem_get_info`; the rest is left to parameters, optimizer
    state and activations), or 6 GB on the CPU device, as the JAX package
    budgets a backend that reports no memory."""
    env = os.environ.get("TRANSMF_CACHE_BUDGET_MB")
    if env:
        return int(float(env) * 2**20)
    device = torch.device(device)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return int(0.4 * total)
    return CPU_BUDGET


def fits_budget(loader, budget: Optional[int] = None, device="cuda") -> bool:
    if budget is None:
        budget = hbm_budget(device)
    return cache_bytes(loader) <= budget


def _stack_rows(src, idxs, key, shape, dtype, device) -> torch.Tensor:
    """Rows `idxs` of `key` in one device tensor, copied a row at a time
    (no host buffer of the whole set); at least one row, zeros if none."""
    out = torch.zeros((max(1, len(idxs)), *shape), dtype=dtype,
                      device=device)
    for j, s in enumerate(idxs):
        out[j].copy_(torch.as_tensor(src[s][key]))
    return out


def _check_no_transform(loader, feed):
    if getattr(loader, "sample_transform", None) is not None:
        # the cache stores raw decoded volumes and gathers them on the
        # device: a host per-sample transform would silently never run
        raise ValueError(
            f"{feed} cannot apply the loader's host-side sample_transform "
            "(cached volumes never revisit the host); stream with "
            "pipeline.DeviceFeed instead")


class DeviceCachedFeed:
    """Loader adapter yielding device-resident, mask-padded batches with no
    per-epoch volume transfer after the one-time fill.

    Drop-in for `pipeline.DeviceFeed` in `Trainer.fit` / `evaluate`:
    `len` / `peek` / `batch_size` delegate to the wrapped loader, and
    `device_resident=True` tells the trainer the batches need no further
    padding or placement. With `group` (a torch.distributed process group)
    the store is row-sharded over the ranks and each batch is this rank's
    rows of the global one (see the module's docstring); `pad_to` must
    then divide over the world size (default: the batch size rounded up).
    """

    device_resident = True

    def __init__(self, loader, device="cuda", pad_to: Optional[int] = None,
                 group=None):
        _check_no_transform(loader, "DeviceCachedFeed")
        self.loader = loader
        self.device = torch.device(device)
        self.group = group
        self.world, self.rank = 1, 0
        if group is not None:
            import torch.distributed as dist

            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        base = loader.batch_size
        self.pad_to = (pad_to if pad_to is not None
                       else padded_batch(base, self.world))
        if self.pad_to % self.world:
            raise ValueError(f"pad_to={self.pad_to} does not divide over "
                             f"{self.world} ranks")
        self._store = None
        self._labels = None
        self._pos: Dict[int, int] = {}

    # ----- loader protocol -----

    def __len__(self):
        return len(self.loader)

    @property
    def batch_size(self):
        return self.loader.batch_size

    def peek(self):
        return self.loader.peek()

    # ----- cache fill -----

    def _fill(self):
        src = self.loader.source
        idxs = [int(i) for i in self.loader.indices]
        self._pos = {s: j for j, s in enumerate(idxs)}
        # rows a rank holds
        self._per = padded_batch(len(idxs), self.world) // self.world
        mine = idxs[self.rank * self._per:(self.rank + 1) * self._per]
        shape, _, _ = _vol_shape(self.loader)
        dtype = _torch_dtype(src.dtype)
        self._store = {k: _stack_rows(src, mine, k, shape, dtype,
                                      self.device) for k in src.keys}
        labels = np.asarray([int(src.records[s]["label"]) for s in idxs],
                            np.int32)
        self._labels = torch.from_numpy(labels).to(self.device)

    def _exchange(self, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """This rank's slice of the global batch whose cache rows are `rows`
        (pad_to,), from the ranks that hold them: rank q sends rank d the
        rows of d's slice that q owns, in slice order; d puts each where it
        belongs."""
        import torch.distributed as dist

        w, per = self.world, self._per
        b_loc = self.pad_to // w
        owner = rows // per
        mine = slice(self.rank * b_loc, (self.rank + 1) * b_loc)
        send = [np.flatnonzero(owner[d * b_loc:(d + 1) * b_loc] == self.rank)
                + d * b_loc for d in range(w)]
        recv = [np.flatnonzero(owner[mine] == q) for q in range(w)]
        send_rows = np.concatenate(send) if send else np.empty(0, np.int64)
        local = torch.from_numpy(rows[send_rows] - self.rank * per).to(
            self.device)
        place = torch.from_numpy(np.concatenate(recv)).to(self.device)
        out = {}
        for k, store in self._store.items():
            src = store.index_select(0, local)
            got = torch.empty((b_loc, *store.shape[1:]), dtype=store.dtype,
                              device=self.device)
            dist.all_to_all_single(
                got, src, output_split_sizes=[len(r) for r in recv],
                input_split_sizes=[len(r) for r in send], group=self.group)
            out[k] = torch.empty_like(got).index_copy_(0, place, got)
        return out

    # ----- iteration -----

    def __iter__(self):
        if self._store is None:
            self._fill()
        pos = self._pos
        b_loc = self.pad_to // self.world
        mine = slice(self.rank * b_loc, (self.rank + 1) * b_loc)
        for idx in self.loader._batches():
            rows = np.empty(self.pad_to, np.int64)
            b = len(idx)
            for j, s in enumerate(idx):
                rows[j] = pos[int(s)]
            if b < self.pad_to:  # wrap-around duplicates (pipeline.pad_batch)
                rows[b:] = rows[np.arange(self.pad_to - b) % b]
            if self.group is None:
                dev = torch.from_numpy(rows).to(self.device)
                out = {k: v.index_select(0, dev)
                       for k, v in self._store.items()}
            else:
                out = self._exchange(rows)
            out["label"] = self._labels.index_select(
                0, torch.from_numpy(rows[mine]).to(self.device))
            out["mask"] = (torch.arange(self.pad_to, device=self.device)
                           < b).float()[mine]
            out["_n_real"] = b  # host metadata (trainer BN-mask dispatch)
            yield out


class HybridCachedFeed:
    """Hot/cold tiered feed for datasets over the budget.

    `DeviceCachedFeed` is all or nothing: one volume over the budget and
    the whole epoch streams. Here the first `n_hot` rows of the loader's
    index list, as many as fit the budget, live in a device store (the
    "hot" tier); per batch the hot rows are gathered on the device and only
    the cold rows are transferred, so the per-epoch transfer shrinks by the
    hot fraction.

     - The batch order is the host path's, bit for bit (the wrapped
       Loader's `_batches()` drives the epoch); each batch is put together
       by a gather of the hot rows and an `index_copy_` of the streamed
       cold rows into their places.
     - Labels of all rows live on the device (4 bytes each).
     - A worker thread reads the cold rows of each batch from the host
       cache, `DEPTH` batches ahead, and `pipeline.device_prefetch` moves
       them through pinned memory on a side stream, as `DeviceFeed` does.
       (The JAX package pads the cold count to a power of two to bound its
       compiles; eager PyTorch has nothing to compile, and the padding
       would only write duplicates.)
    """

    device_resident = True

    def __init__(self, loader, device="cuda", pad_to: Optional[int] = None,
                 budget: Optional[int] = None):
        _check_no_transform(loader, "HybridCachedFeed")
        self.loader = loader
        self.device = torch.device(device)
        self.pad_to = pad_to if pad_to is not None else loader.batch_size
        if budget is None:
            budget = hbm_budget(self.device)
        shape, itemsize, n_keys = _vol_shape(loader)
        self._shape = shape
        row_bytes = int(np.prod(shape)) * itemsize * n_keys
        self.n_hot = min(len(loader.indices), max(0, budget // row_bytes))
        self._store = None
        self._labels = None
        self._pos: Dict[int, int] = {}

    # ----- loader protocol -----

    def __len__(self):
        return len(self.loader)

    @property
    def batch_size(self):
        return self.loader.batch_size

    def peek(self):
        return self.loader.peek()

    @property
    def hot_fraction(self) -> float:
        return self.n_hot / max(1, len(self.loader.indices))

    # ----- fill -----

    def _fill(self):
        src = self.loader.source
        idxs = [int(i) for i in self.loader.indices]
        hot = idxs[: self.n_hot]
        self._pos = {s: j for j, s in enumerate(hot)}
        self._all_pos = {s: j for j, s in enumerate(idxs)}
        dtype = _torch_dtype(src.dtype)
        self._store = {k: _stack_rows(src, hot, k, self._shape, dtype,
                                      self.device) for k in src.keys}
        labels = np.asarray([int(src.records[s]["label"]) for s in idxs],
                            np.int32)
        self._labels = torch.from_numpy(labels).to(self.device)

    # ----- iteration -----

    def _host_batches(self):
        """Per loader batch, the transfer-ready description of it: row ids
        into the hot store (0 for cold rows) and into all rows, the cold
        rows' positions, the cold rows' volumes stacked per key (numpy or
        bfloat16 tensors, as the source holds them) and the real count."""
        src = self.loader.source
        pos, all_pos = self._pos, self._all_pos
        for idx in self.loader._batches():
            b = len(idx)
            padded = [int(s) for s in idx]
            if b < self.pad_to:  # wrap-around duplicates (pipeline.pad_batch)
                padded += [padded[j % b] for j in range(self.pad_to - b)]
            rows_store = np.zeros(self.pad_to, np.int64)
            rows_all = np.empty(self.pad_to, np.int64)
            cold = []
            for j, s in enumerate(padded):
                rows_all[j] = all_pos[s]
                if s in pos:
                    rows_store[j] = pos[s]
                else:
                    cold.append((j, s))
            out = {"rows_store": rows_store, "rows_all": rows_all,
                   "cold_pos": np.asarray([j for j, _ in cold], np.int64),
                   "_n_real": b}
            if cold:
                items = src.get_batch([s for _, s in cold])
                for k in src.keys:
                    values = [it[k] for it in items]
                    out[f"cold_{k}"] = (torch.stack(values)
                                        if isinstance(values[0], torch.Tensor)
                                        else np.stack(values))
            yield out

    def _threaded(self):
        """`_host_batches` run by a worker thread, `DEPTH` batches ahead."""
        q: queue.Queue = queue.Queue(maxsize=DEPTH)
        done = object()

        def worker():
            try:
                for item in self._host_batches():
                    q.put(item)
                q.put(done)
            except BaseException as e:  # surface errors in the consumer
                q.put(e)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __iter__(self):
        if self._store is None:
            self._fill()
        keys = self.loader.source.keys
        for dev in device_prefetch(self._threaded(), self.device, DEPTH):
            rows_store = dev["rows_store"]
            out = {k: v.index_select(0, rows_store)
                   for k, v in self._store.items()}
            if dev["cold_pos"].numel():  # the streamed cold rows in place
                for k in keys:
                    out[k].index_copy_(0, dev["cold_pos"], dev[f"cold_{k}"])
            out["label"] = self._labels.index_select(0, dev["rows_all"])
            b = dev["_n_real"]
            out["mask"] = (torch.arange(self.pad_to, device=self.device)
                           < b).float()
            out["_n_real"] = b
            yield out
