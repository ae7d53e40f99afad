"""Run logging: a running-average meter and a JSON-lines run log.

The port's copy of the file-backed part of ``heatnet_tpu/io/logging.py``
(``AverageMeter``, and ``RunLogger`` without wandb): one JSON object per
``log`` call in ``<log_dir>/<project>-<unix time>.jsonl``, and one
``{"_type": "config", ...}`` object per ``update_config`` call (:52-58).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    """``d`` with each value JSON can hold as it is, a one-element array as
    its item, anything else as its ``str`` (logging.py:106-117)."""
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = v.item() if hasattr(v, "item") and getattr(v, "size", 2) == 1 else str(v)
    return out


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
        self.config: Dict[str, Any] = {}

    def update_config(self, cfg: Any) -> None:
        """``wandb.config.update(args)``: a dict or an ``argparse.Namespace``,
        merged into ``config`` and written whole as one config record."""
        if hasattr(cfg, "__dict__") and not isinstance(cfg, dict):
            cfg = vars(cfg)
        self.config.update(dict(cfg))
        self._file.write(json.dumps({"_type": "config", **_jsonable(self.config)}) + "\n")
        self._file.flush()

    def log(self, metrics: Dict[str, Any]) -> None:
        self._file.write(json.dumps({"_step": self._step, **metrics}) + "\n")
        self._file.flush()
        self._step += 1

    def finish(self) -> None:
        self._file.close()
