"""Bad fixture for the exceptions pass (RA501): handlers that swallow."""


def swallow_pass(engine):
    try:
        engine.step()
    except RuntimeError:                      # expect: RA501
        pass


def swallow_with_work(engine):
    try:
        engine.step()
    except (ValueError, KeyError):            # expect: RA501
        engine.reset()


def swallow_bare(engine):
    try:
        engine.step()
    except Exception:                         # expect: RA501
        return None


def swallow_return_default(xs):
    try:
        return xs[0]
    except IndexError:                        # expect: RA501
        return 0
