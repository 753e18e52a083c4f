"""Offline readers of the port's telemetry, each run with ``python -m``:

* ``horovod_tpu_torch.tools.metrics_summary``: the per-step JSONL
  (``HOROVOD_TPU_METRICS_FILE``) as a table, or ``--check`` as a gate;
* ``horovod_tpu_torch.tools.flight_analyze``: per-rank flight dumps
  merged into a straggler and critical-path report;
* ``horovod_tpu_torch.tools.trace_merge``: host timelines, flight dumps,
  profiler samples and incident logs on one clock-aligned Chrome trace;
* ``horovod_tpu_torch.tools.device_summary``: a ``torch.profiler``
  trace's card time by category and by kernel, idle and attribution.

The twins of the JAX package's ``scripts/metrics_summary.py``,
``flight_analyze.py``, ``trace_merge.py`` and ``xplane_summary.py``: the
same host files give the same output; the device traces are Chrome
traces here, ``.xplane.pb`` there.
"""
