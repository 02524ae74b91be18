"""Traffic drivers, one file each, found by the ``driver`` name a traffic
file gives. Each defines ``Cell(config, traffic, seed, device)`` with
``setup()``, ``window(seconds)``, ``after_window(traced)``, ``end_to_end()``,
``counters()``, ``release()`` and ``check()``."""
