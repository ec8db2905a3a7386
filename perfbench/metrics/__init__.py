"""Per-layer metrics, one reader a metric: ``<name>.py`` with
``read(run)``, which returns the metric's value or None where the run holds
nothing to read (``perfbench.harness.Run``)."""
