"""Per-layer metric readers, one file per metric, named as the metric is in
``BENCHMARK.json`` (``<name>.py``, loaded by path). Each defines
``read(ctx)``, which returns the metric's value or None where the traced
run gave it nothing to read. ``ctx.window`` is the traced window
(``retrieval_bench.trace.Window``), ``ctx.counters`` the traffic driver's counts."""
