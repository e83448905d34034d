"""Scalar logging: TensorBoard event files + a plain JSONL mirror.

Keeps the reference's observability contract (SummaryWriter scalars
Train/Loss, Test/Acc, recall/precision/f1/ap/roc_auc keyed by global
iteration — main.py:103-110, 414-415) so the reference's board_reader /
plotting conventions work, while the JSONL mirror makes results greppable
without TensorBoard.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class ScalarLogger:
    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        self._tb = None
        self._jsonl = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None
            self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "ts": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
