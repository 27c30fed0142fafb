"""File+stdout logger with the reference's log format.

A copy of transmf_ad_tpu/utils/logging.py (reference: utils/utils.py:85-99):
appends to `<dir>/log.txt`; `print_message` echoes to stdout,
`print_message_nocli` writes file-only (used for per-fold test lines in the
main log).
"""

from __future__ import annotations

import os


def mkdirs(paths):
    if isinstance(paths, (list, tuple)):
        for p in paths:
            os.makedirs(p, exist_ok=True)
    else:
        os.makedirs(paths, exist_ok=True)


class Logger:
    def __init__(self, log_dir: str):
        mkdirs(log_dir)
        self.log_name = os.path.join(log_dir, "log.txt")
        with open(self.log_name, "a") as f:
            f.write(f"================ {self.log_name} ================\n")

    def print_message(self, msg: str):
        print(msg, flush=True)
        with open(self.log_name, "a") as f:
            f.write(f"{msg}\n")

    def print_message_nocli(self, msg: str):
        with open(self.log_name, "a") as f:
            f.write(f"{msg}\n")
