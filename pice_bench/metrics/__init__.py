"""One reader a metric, `<metric>.py`, loaded by name: `read(ctx)` returns
a number, or None where it finds nothing to read."""
