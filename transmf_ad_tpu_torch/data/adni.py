"""ADNI dataset index: CSV -> list of sample records.

A copy of transmf_ad_tpu/data/adni.py. Mirrors the behavior of the reference index (reference: datasets/ADNI.py:16-56):
``ADNI.csv`` has columns ``Subject, Group, Age``; rows are filtered by task and
mapped to binary labels; volumes live at ``<root>/MRI/<subject>.nii.gz`` and
``<root>/PET/<subject>.nii.gz``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

TASK_LABELS = {
    "ADCN": {"CN": 0, "AD": 1},
    "pMCIsMCI": {"sMCI": 0, "pMCI": 1},
    "MCICN": {"CN": 0, "sMCI": 1, "pMCI": 1, "MCI": 1},
}


class ADNI:
    """Index of paired MRI/PET NIfTI volumes for one classification task.

    ``data_dict`` is a list of dicts with keys ``MRI``/``PET`` (paths),
    ``label`` (int), ``age`` (float), ``Subject`` (str) — the same record
    schema the reference feeds to its transform pipeline.
    """

    def __init__(self, dataroot: str, label_filename: str = "ADNI.csv",
                 task: str = "ADCN"):
        if task not in TASK_LABELS:
            raise ValueError(f"unknown task {task!r}; expected one of {list(TASK_LABELS)}")
        self.task = task
        self.label_dict = TASK_LABELS[task]
        mri_dir = os.path.join(dataroot, "MRI")
        pet_dir = os.path.join(dataroot, "PET")

        rows: List[Dict] = []
        with open(os.path.join(dataroot, label_filename), newline="") as f:
            for row in csv.DictReader(f):
                if row["Group"] in self.label_dict:
                    rows.append(row)
        self.data_dict = [
            {
                "MRI": os.path.join(mri_dir, r["Subject"] + ".nii.gz"),
                "PET": os.path.join(pet_dir, r["Subject"] + ".nii.gz"),
                "label": self.label_dict[r["Group"]],
                "age": float(r.get("Age") or 0.0),
                "Subject": r["Subject"],
            }
            for r in rows
        ]

    def __len__(self) -> int:
        return len(self.data_dict)

    def class_counts(self):
        """(negatives, positives) — used for inverse-frequency weights."""
        labels = [d["label"] for d in self.data_dict]
        return float(labels.count(0)), float(labels.count(1))
