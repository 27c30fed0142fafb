"""Synthetic ADNI-format dataset fixture.

A copy of transmf_ad_tpu/data/synthetic.py: the same seed writes the same
volumes and CSV. Writes a directory tree matching what the reference README
documents (reference: README.md:13-37): ``<root>/MRI/<subj>.nii.gz``,
``<root>/PET/<subj>.nii.gz``, ``<root>/ADNI.csv`` with columns
``Subject,Group,Age``. Volumes get a class-dependent signal (a bright blob
whose radius scales with the label) so training on the fixture is learnable —
used by integration tests and benchmarks.

`workers` > 1 writes the files from a thread pool (gzip releases the GIL);
the volumes are drawn in the same order, so the tree is the same.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import nifti

GROUPS = ("CN", "AD", "sMCI", "pMCI")


def make_synthetic_adni(
    root: str,
    n_per_group: int = 6,
    shape=(32, 40, 32),
    groups=GROUPS,
    seed: int = 0,
    workers: int = 1,
) -> str:
    """Create a synthetic ADNI tree under `root`; returns `root`."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "MRI"), exist_ok=True)
    os.makedirs(os.path.join(root, "PET"), exist_ok=True)
    coords = np.stack(
        np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    )
    r2 = (coords**2).sum(0)

    rows = []
    pool = ThreadPoolExecutor(workers) if workers > 1 else None
    writes = []

    def save(path, vol):
        if pool is None:
            nifti.save(path, vol)
        else:
            writes.append(pool.submit(nifti.save, path, vol))

    for group in groups:
        # Positive classes (AD, pMCI) get a larger bright blob.
        radius = 0.55 if group in ("AD", "pMCI", "MCI") else 0.35
        blob = np.exp(-r2 / (radius**2)).astype(np.float32)
        for i in range(n_per_group):
            subj = f"{group}_{i:03d}"
            for mod, gain in (("MRI", 1.0), ("PET", 0.7)):
                vol = gain * blob + 0.15 * rng.standard_normal(shape).astype(
                    np.float32
                )
                save(os.path.join(root, mod, subj + ".nii.gz"), vol)
            rows.append(
                {"Subject": subj, "Group": group, "Age": 70 + rng.integers(0, 15)}
            )
    if pool is not None:
        pool.shutdown()
        for done in writes:
            done.result()  # a failed write raises here
    with open(os.path.join(root, "ADNI.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Subject", "Group", "Age"])
        w.writeheader()
        w.writerows(rows)
    return root
