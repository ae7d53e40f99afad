"""Run logging: a running-average meter and a JSON-lines run log.

The port's copy of the file-backed part of ``heatnet_tpu/io/logging.py``
(``AverageMeter``, and ``RunLogger`` without wandb): one JSON object per
``log`` call in ``<log_dir>/<project>-<unix time>.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class AverageMeter:
    """Running average (scripts/main.py:327-343)."""

    def __init__(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = float(val)
        self.sum += self.val * n
        self.count += n
        self.avg = self.sum / self.count


class RunLogger:
    def __init__(self, project: str, log_dir: str = "runs"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{project}-{int(time.time())}.jsonl")
        self._file = open(self.path, "a")
        self._step = 0

    def log(self, metrics: Dict[str, Any]) -> None:
        self._file.write(json.dumps({"_step": self._step, **metrics}) + "\n")
        self._file.flush()
        self._step += 1

    def finish(self) -> None:
        self._file.close()
