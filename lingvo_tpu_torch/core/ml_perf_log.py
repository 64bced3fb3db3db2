"""MLPerf-compliance structured logging (port of lingvo_tpu/core/ml_perf_log.py;
`mlperf_print:80` emitting `:::MLLOG` lines; hooks in the executor at
run start/stop and per-block boundaries).

Format (MLPerf logging spec): one line per event —
  :::MLLOG {"namespace": ..., "time_ms": ..., "event_type": ...,
            "key": ..., "value": ..., "metadata": {...}}
"""

from __future__ import annotations

import json
import sys
import time

INTERVAL_START = "INTERVAL_START"
INTERVAL_END = "INTERVAL_END"
POINT_IN_TIME = "POINT_IN_TIME"

# standard keys (subset the executor emits)
RUN_START = "run_start"
RUN_STOP = "run_stop"
INIT_START = "init_start"
INIT_STOP = "init_stop"
BLOCK_START = "block_start"
BLOCK_STOP = "block_stop"
EVAL_ACCURACY = "eval_accuracy"
GLOBAL_BATCH_SIZE = "global_batch_size"
SUBMISSION_BENCHMARK = "submission_benchmark"

_EVENT_TYPES = {
    RUN_START: INTERVAL_START,
    RUN_STOP: INTERVAL_END,
    INIT_START: INTERVAL_START,
    INIT_STOP: INTERVAL_END,
    BLOCK_START: INTERVAL_START,
    BLOCK_STOP: INTERVAL_END,
}


class MlPerfLogger:
  """Writes :::MLLOG lines to a file (and optionally stderr)."""

  def __init__(self, path: str | None = None, benchmark: str = "",
               org: str = "", platform: str = "", echo: bool = False):
    # truncate: the compliance checker expects exactly ONE run per log
    self._file = open(path, "w") if path else None
    self._echo = echo
    self._benchmark = benchmark
    if benchmark:
      self.Print(SUBMISSION_BENCHMARK, benchmark)
    if org:
      self.Print("submission_org", org)
    if platform:
      self.Print("submission_platform", platform)

  def Print(self, key: str, value=None, metadata: dict | None = None,
            event_type: str | None = None):
    """Emits one MLLOG line (ref mlperf_print:80)."""
    record = {
        "namespace": "",
        "time_ms": int(time.time() * 1000),
        "event_type": event_type or _EVENT_TYPES.get(key, POINT_IN_TIME),
        "key": key,
        "value": value,
        "metadata": metadata or {},
    }
    line = ":::MLLOG " + json.dumps(record)
    if self._file is not None:
      self._file.write(line + "\n")
      self._file.flush()
    if self._echo:
      print(line, file=sys.stderr)

  def Close(self):
    if self._file is not None:
      self._file.close()
      self._file = None
