"""Traffic comes from the seed alone: one seed gives the same pool, order
and draws, another seed different ones, and the same sizes."""

from __future__ import annotations

import torch

from portbench import harness
from portbench.tests import tiny


def _train_traffic(seed):
    entry, cfg, mix, limits = tiny.cell_files(tiny.CELLS[0])
    drv = harness.kind(mix["kind"]).CellRun(cfg, mix, seed, "cpu", limits)
    drv.setup()
    return (drv.pool["MRI"].clone(), drv.pool["PET"].clone(),
            drv.labels.clone(), [i.clone() for i in drv.first_ids],
            drv.weights)


def _same(a, b):
    if isinstance(a, dict):
        return all(torch.equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_train_traffic_is_the_seeds():
    big = 2**31 + 12345  # seeds may exceed 32 signed bits
    a, b, c = _train_traffic(big), _train_traffic(big), _train_traffic(7)
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not any(_same(x, y) for x, y in zip(a[:2], c[:2]))
    assert not _same(a[4], c[4])  # the weights
    assert all(x.shape == y.shape for x, y in zip(a[:3], c[:3]))
    ids = torch.cat(a[3])
    assert len(set(ids.tolist())) == ids.numel()  # first rows all differ


def test_subseeds_differ():
    seeds = {harness.subseed(s, k) for s in (0, 1, 2**31 + 5)
             for k in range(5)}
    assert len(seeds) == 15 and all(0 <= s < 2**63 for s in seeds)
