"""Run-history record for resume (reference AiR/utils/recording.py:11-47).

Writes ``history_record.json`` with {epoch, iteration, best_metric}.

The port's own copy of ``scanpaths_tpu/utils/recording.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import json
from os.path import join


class RecordManager:
    def __init__(self, serialization_dir: str,
                 filename_prefix: str = "history_record"):
        self._dir = serialization_dir
        self._prefix = filename_prefix
        self.record = {"epoch": -1, "iteration": -1, "best_metric": None}

    @property
    def _path(self):
        return join(self._dir, self._prefix + ".json")

    def load(self):
        with open(self._path) as f:
            self.record = json.load(f)

    def save(self, epoch, iteration, best_metric):
        self.record.update(epoch=epoch, iteration=iteration,
                           best_metric=best_metric)
        with open(self._path, "w") as f:
            json.dump(self.record, f, indent=2)

    def init_record(self):
        with open(self._path, "w") as f:
            json.dump(self.record, f, indent=2)

    def get_epoch(self):
        return self.record["epoch"]

    def get_iteration(self):
        return self.record["iteration"]

    def get_best_metric(self):
        return self.record["best_metric"]
