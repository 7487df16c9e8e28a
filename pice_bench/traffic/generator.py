"""The one traffic generator: a mix file's parameters -> requests, and the
closed- and open-loop drivers that offer them.

A mix (`traffic/<mix>.json`) gives the request sizes as ranges and a
`design_seed`. The sizes of a pool of `pool` requests are fixed by the
design seed alone (stratified quantiles of a log-uniform law, query and
answer lengths paired by a fixed permutation), so every run seed offers
the same set of sizes; the run seed only orders them and writes their
text. An open loop's gaps are likewise a fixed set of exponential
quantiles at `rate_rps` (the Poisson law of the program's
`serving/loadgen.synthesize_trace`), ordered by the run seed. A mix with
`order_block` B orders both in runs of B, each run holding one member of
each of B strata of neighbouring sizes (or gaps): every seed then offers
the same mix of long and short, and of bursts and lulls, in any stretch
of B requests. Prompts are ASCII text, one byte a token.

Every time is taken from when the request was due: in a closed loop a
client's next request is due when its previous answer returned, in an
open loop at its scheduled arrival, whenever the generator got to send it.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import random
import time
from pathlib import Path
from typing import Awaitable, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
LETTERS = "abcdefghijklmnopqrstuvwxyz"


@dataclasses.dataclass
class Shape:
    query_tokens: int
    max_new_tokens: int
    category: str


@dataclasses.dataclass
class Item:
    """One request as offered: its index in the run, text and sizes."""
    index: int
    query: str
    max_new_tokens: int
    category: str


def load(mix: str, folder: Path = HERE) -> dict:
    with open(folder / f"{mix}.json") as f:
        return json.load(f)


def _log_uniform(lo: int, hi: int, u: float) -> int:
    return int(round(math.exp(math.log(lo) + u * (math.log(hi)
                                                  - math.log(lo)))))


def design(p: dict) -> List[Shape]:
    """The pool's sizes, fixed by `design_seed` alone."""
    rng = random.Random(p["design_seed"])
    n = p["pool"]
    pair = list(range(n))
    rng.shuffle(pair)
    cats = p["categories"]
    out = []
    for i in range(n):
        q = _log_uniform(*p["query_tokens"], (i + 0.5) / n)
        m = _log_uniform(*p["max_new_tokens"], (pair[i] + 0.5) / n)
        out.append(Shape(q, m, cats[i % len(cats)]))
    return out


def _words() -> List[str]:
    rng = random.Random("words")
    return ["".join(rng.choice(LETTERS) for _ in range(rng.randint(2, 9)))
            for _ in range(4096)]


WORDS = _words()


def text(rng: random.Random, n: int) -> str:
    """n bytes of lowercase words, with a full stop every twelfth word."""
    out = ""
    while len(out) < n:
        ws = rng.choices(WORDS, k=n // 4 + 12)
        out += " ".join(w + "." if i % 12 == 11 else w
                        for i, w in enumerate(ws)) + " "
    return out[:n]


def ordered(n: int, block: int, rng: random.Random) -> List[int]:
    """A permutation of range(n) drawn from `rng`: uniform for `block` 1 or
    less, else in runs of `block` places, each run holding one index of
    each of `block` strata of consecutive indices, in an order of its own."""
    if block <= 1:
        out = list(range(n))
        rng.shuffle(out)
        return out
    strata = [list(range(j * n // block, (j + 1) * n // block))
              for j in range(block)]
    for st in strata:
        rng.shuffle(st)
    out = []
    for k in range(max(len(st) for st in strata)):
        run = [st[k] for st in strata if k < len(st)]
        rng.shuffle(run)
        out += run
    return out


class Stream:
    """The run's requests in order: the pool's shapes ordered by the run
    seed, their text written from it, cycling through the pool."""

    def __init__(self, p: dict, seed: int):
        self.shapes = design(p)
        self.order = ordered(len(self.shapes), p.get("order_block", 1),
                             random.Random(seed))
        self.seed = seed
        self.n = 0

    def next(self) -> Item:
        i = self.n
        self.n += 1
        s = self.shapes[self.order[i % len(self.order)]]
        rng = random.Random(f"{self.seed}/{i}")
        return Item(i, text(rng, s.query_tokens), s.max_new_tokens,
                    s.category)


def gaps(p: dict, seed: int) -> List[float]:
    """An open loop's inter-arrival gaps: the exponential law's quantiles
    at `rate_rps` over the pool, ordered by the run seed."""
    n = p["pool"]
    g = [-math.log(1.0 - (i + 0.5) / n) / p["rate_rps"] for i in range(n)]
    order = ordered(n, p.get("order_block", 1), random.Random(f"gaps/{seed}"))
    return [g[i] for i in order]


Send = Callable[[Item, float], Awaitable[None]]


class ClosedLoop:
    """`clients` callers, each sending its next request when its answer
    returns (no think time)."""

    def __init__(self, p: dict, seed: int):
        self.stream = Stream(p, seed)
        self.clients = p["clients"]
        self.stopped = False
        self.tasks: List[asyncio.Task] = []
        self.late: List[float] = []
        self.dues: List[float] = []

    async def _client(self, send: Send) -> None:
        while not self.stopped:
            await send(self.stream.next(), time.perf_counter())

    def start(self, send: Send) -> None:
        loop = asyncio.get_running_loop()
        self.tasks = [loop.create_task(self._client(send))
                      for _ in range(self.clients)]

    def stop(self) -> None:
        self.stopped = True


class OpenLoop:
    """Requests sent at their scheduled arrivals, whatever is in flight."""

    def __init__(self, p: dict, seed: int):
        self.stream = Stream(p, seed)
        self.gaps = gaps(p, seed)
        self.stopped = False
        self.tasks: List[asyncio.Task] = []
        self.late: List[float] = []          # seconds each send ran late
        self.dues: List[float] = []          # ... and when it was due
        self._gen: Optional[asyncio.Task] = None

    async def _generate(self, send: Send) -> None:
        loop = asyncio.get_running_loop()
        due = time.perf_counter()
        k = 0
        while not self.stopped:
            due += self.gaps[k % len(self.gaps)]
            k += 1
            wait = due - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
            if self.stopped:
                return
            self.late.append(max(time.perf_counter() - due, 0.0))
            self.dues.append(due)
            self.tasks.append(loop.create_task(send(self.stream.next(),
                                                    due)))

    def start(self, send: Send) -> None:
        self._gen = asyncio.get_running_loop().create_task(
            self._generate(send))
        self.tasks.append(self._gen)

    def stop(self) -> None:
        self.stopped = True


LOOPS: Dict[str, type] = {"closed": ClosedLoop, "open": OpenLoop}


def driver(p: dict, seed: int):
    return LOOPS[p["loop"]](p, seed)
