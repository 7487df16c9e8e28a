"""Good fixture for the exceptions pass (RA501): every caught fault is
re-raised or recorded where telemetry can see it."""


def reraise(engine):
    try:
        engine.step()
    except MemoryError:
        engine.abort_all()
        raise


def record_to_monitor(engine, monitor):
    try:
        engine.step()
    except RuntimeError:
        monitor.record_edge_result(False)


def bump_counter(self, engine):
    try:
        engine.step()
    except RuntimeError:
        self.crash_events += 1


def bump_stats_dict(self, engine):
    try:
        engine.step()
    except ValueError:
        self.stats["faults"] = self.stats.get("faults", 0) + 1


def waived_swallow(xs):
    try:
        return xs[0]
    # repro-analysis: disable=RA501 reason=absence of a value IS the result
    except IndexError:
        return None
