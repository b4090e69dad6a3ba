"""One reader a metric: ``<name>.py`` with ``read(run) -> float | None``."""
