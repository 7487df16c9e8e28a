"""The traffic generator: sizes fixed by the mix, order and text by the
seed; the closed loop's and the open loop's due-time clocks."""
import asyncio
import collections
import time

from pice_bench.traffic import generator
from pice_bench.tests import tiny  # noqa: F401  (sys.path)


def _mix():
    return generator.load("progressive")


def test_same_seed_same_requests():
    a = generator.Stream(_mix(), 3_000_000_001)
    b = generator.Stream(_mix(), 3_000_000_001)
    for _ in range(20):
        assert a.next() == b.next()


def test_seeds_share_the_set_of_sizes():
    p = _mix()
    n = p["pool"]
    one = [generator.Stream(p, s) for s in (1, 2_147_483_659)]
    sizes = [collections.Counter((len(i.query),
                                  i.max_new_tokens)
                                 for i in (s.next() for _ in range(n)))
             for s in one]
    assert sizes[0] == sizes[1]
    first = [generator.Stream(p, s).next() for s in (1, 2)]
    assert first[0].query != first[1].query


def test_sizes_cover_the_ranges_log_uniformly():
    p = _mix()
    shapes = generator.design(p)
    q = sorted(s.query_tokens for s in shapes)
    lo, hi = p["query_tokens"]
    assert lo <= q[0] and q[-1] <= hi
    # log-uniform: the median near the geometric mean
    assert abs(q[len(q) // 2] - (lo * hi) ** 0.5) < 0.02 * (lo * hi) ** 0.5
    assert all(s.category in p["categories"] for s in shapes)


def test_text_is_ascii_of_the_asked_length():
    import random
    for n in (1, 37, 1024, 6144):
        t = generator.text(random.Random(n), n)
        assert len(t) == n and len(t.encode()) == n
        assert all(0 < ord(c) < 128 for c in t)


def test_open_loop_gaps_are_the_exponential_quantiles():
    p = generator.load("cloud-rag")
    g1, g2 = generator.gaps(p, 1), generator.gaps(p, 2)
    assert sorted(g1) == sorted(g2) and g1 != g2
    mean = sum(g1) / len(g1)
    assert abs(mean - 1.0 / p["rate_rps"]) < 0.03 / p["rate_rps"]


def test_closed_loop_due_is_the_previous_return():
    p = dict(_mix(), clients=2)
    drv = generator.ClosedLoop(p, 5)
    log = []

    async def send(item, due):
        log.append(("due", due))
        await asyncio.sleep(0.01)
        log.append(("done", time.perf_counter()))

    async def main():
        drv.start(send)
        await asyncio.sleep(0.1)
        drv.stop()
        await asyncio.gather(*drv.tasks)

    asyncio.run(main())
    dues = [t for k, t in log if k == "due"]
    dones = [t for k, t in log if k == "done"]
    assert len(dues) >= 8
    # each client's next request is due no earlier than its last return
    for d in dues[2:]:
        assert any(0 <= d - r < 0.005 for r in dones)


def test_open_loop_sends_on_schedule_and_records_lateness():
    p = dict(generator.load("cloud-rag"), rate_rps=200.0)
    drv = generator.OpenLoop(p, 9)
    dues = []

    async def send(item, due):
        dues.append(due)

    async def main():
        drv.start(send)
        await asyncio.sleep(0.2)
        drv.stop()
        await asyncio.gather(*drv.tasks)

    asyncio.run(main())
    assert len(dues) > 10
    steps = [b - a for a, b in zip(dues, dues[1:])]
    assert all(abs(s - g) < 1e-9 for s, g in zip(steps, drv.gaps[1:]))
    assert len(drv.late) == len(dues) and min(drv.late) >= 0
    assert drv.dues == dues


def test_blocked_order_spreads_each_run_over_the_strata():
    import random
    for n, block in ((220, 20), (23, 4)):
        a = generator.ordered(n, block, random.Random(1))
        b = generator.ordered(n, block, random.Random(2))
        assert sorted(a) == list(range(n)) and a != b
        strata = {i: j for j in range(block)
                  for i in range(j * n // block, (j + 1) * n // block)}
        k = 0
        while k < n:
            run = a[k:k + block]
            assert len({strata[i] for i in run}) == len(run)
            k += len(run)
    p = dict(generator.load("cloud-rag"), order_block=20)
    g = generator.gaps(p, 7)
    assert sorted(g) == sorted(generator.gaps(p, 8))
    longest = sorted(g)[-11:]
    # the top stratum, the 11 longest of 220 gaps, falls one to a run of 20
    assert all(sum(x in longest for x in g[k:k + 20]) == 1
               for k in range(0, len(g), 20))
