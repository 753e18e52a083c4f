"""Offline readers of the port's telemetry, each run with ``python -m``:

* ``horovod_tpu_torch.tools.metrics_summary``: the per-step JSONL
  (``HOROVOD_TPU_METRICS_FILE``) as a table, or ``--check`` as a gate;
* ``horovod_tpu_torch.tools.flight_analyze``: per-rank flight dumps
  merged into a straggler and critical-path report;
* ``horovod_tpu_torch.tools.trace_merge``: host timelines, flight dumps
  and incident logs on one clock-aligned Chrome trace.

The twins of the JAX package's ``scripts/metrics_summary.py``,
``flight_analyze.py`` and ``trace_merge.py``: the same files give the
same output.
"""
