"""Metrics logging to stdout and a JSONL file (counterpart of
neko_tpu/utils/logging.py, without its wandb sink).

Key namespaces as in the JAX package: training/*, time/*,
evaluation/<task>/<metric>.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(
        self,
        exp_dir: Optional[str] = None,
        use_wandb: bool = False,
        print_logs: bool = True,
        jsonl: bool = True,
    ):
        self.print_logs = print_logs
        self._jsonl_fh = None
        if exp_dir and jsonl:
            os.makedirs(exp_dir, exist_ok=True)
            self._jsonl_fh = open(os.path.join(exp_dir, "metrics.jsonl"), "a")
        if use_wandb:
            print("[neko-tpu-torch] wandb is not ported; logging to stdout/jsonl")

    def log(self, metrics: Dict, step: Optional[int] = None, header: str = "") -> None:
        if self.print_logs:
            print("=" * 80)
            if header:
                print(header)
            for k, v in metrics.items():
                print(f"{k}: {v}")
            print("=" * 80, flush=True)
        if self._jsonl_fh is not None:
            rec = {"_time": time.time(), **({"_step": step} if step is not None else {}),
                   **{k: _jsonable(v) for k, v in metrics.items()}}
            self._jsonl_fh.write(json.dumps(rec) + "\n")
            self._jsonl_fh.flush()

    def finish(self) -> None:
        if self._jsonl_fh is not None:
            self._jsonl_fh.close()
            self._jsonl_fh = None


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)
