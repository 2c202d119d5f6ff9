"""Metrics logging to JSONL (counterpart of
``huggingface_asr_tpu/utils/logging_utils.py::MetricsLogger``, without the
TensorBoard and W&B sinks).

Every metric goes to ``<dir>/metrics.jsonl``; prediction tables go to TSV files
beside it. ``log`` has the signature of a ``fit`` hook.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List


class MetricsLogger:
    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, float]):
        record = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    __call__ = log

    def log_predictions(self, step: int, split: str, refs: List[str], hyps: List[str],
                        max_rows: int = 50):
        path = os.path.join(os.path.dirname(self.path), f"predictions_{split}_{step}.tsv")
        with open(path, "w") as f:
            f.write("label\tprediction\n")
            for r, h in list(zip(refs, hyps))[:max_rows]:
                f.write(f"{r}\t{h}\n")
