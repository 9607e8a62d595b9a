"""Console logging of a run (the port's copy of sparse_vision_tpu/utils/logging.py
without W&B, which the port does not support: ``wandb_status`` is refused).

Train metrics go to ``log_train`` once per dispatch, with the dispatch's last
step, and print every ``log_every`` steps; eval metrics print once per epoch.
"""

from __future__ import annotations


class RunLogger:
    def __init__(self, log_every: int = 100):
        self.log_every = log_every

    @staticmethod
    def _fmt(metrics: dict) -> str:
        return ", ".join(f"{k}={float(v):.5g}" for k, v in sorted(metrics.items()))

    def log_train(self, step: int, metrics: dict) -> None:
        if step % self.log_every == 0:
            print(f"[train step {step}] {self._fmt(metrics)}")

    def log_eval(self, epoch: int, metrics: dict) -> None:
        print(f"[eval epoch {epoch}] {self._fmt(metrics)}")
