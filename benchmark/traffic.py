"""The one traffic generator, and the closed loop that offers its load.

A traffic file (``benchmark/traffic/<name>.json``) holds the mix's
parameters:

- ``loop``: "closed" (a client sends its next request when the last
  one has completed) and ``clients``: 1;
- ``points_per_request``: the points of one request, every rank
  holding the same ones under a mesh;
- ``margin``: the share of each side of the domain the points keep off;
- ``specs``, ``spec_names``: the derivative specs a request answers and
  the names the comparison gives them;
- ``engine``, ``dtype``, ``bucket_sizes``: how the program serves it;
- ``warmup_requests``, ``trace_requests``, ``sample_requests``: the
  requests of set-up, of the traced segment, and the sample of the
  window that the reference checks.

Each request's points are drawn on the device, uniformly from the
configuration's domain less the margin, in the engine's dtype, from one
``torch.Generator`` seeded by ``--seed``: the same seed gives the same
requests, and no two requests repeat.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

SEED_MASK = (1 << 63) - 1
# Set-up's requests come from a stream of their own, so that a window's
# i-th request is the i-th draw of its seed's stream.
_WARMUP_STREAM = 0x5EED


class Client:
    """Draws the requests of one seed's stream."""

    def __init__(self, traffic: dict, domain, seed: int, device, dtype):
        if traffic["loop"] != "closed" or traffic["clients"] != 1:
            raise ValueError("the generator offers a closed loop of one "
                             "client")
        self.n = int(traffic["points_per_request"])
        self.device = torch.device(device)
        self.dtype = dtype
        margin = float(traffic["margin"])
        lo = torch.tensor([b[0] for b in domain], dtype=torch.float64)
        hi = torch.tensor([b[1] for b in domain], dtype=torch.float64)
        self._lo = (lo + margin * (hi - lo)).to(self.device, dtype)
        self._span = ((1.0 - 2.0 * margin) * (hi - lo)).to(self.device, dtype)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed) & SEED_MASK)

    def draw(self) -> torch.Tensor:
        u = torch.rand((self.n, self._lo.shape[0]), generator=self._gen,
                       device=self.device, dtype=self.dtype)
        return self._lo + self._span * u

    @classmethod
    def warmup(cls, traffic: dict, domain, seed: int, device, dtype):
        return cls(traffic, domain, int(seed) ^ _WARMUP_STREAM, device,
                   dtype)


@dataclass
class Window:
    """What the measured window saw: each completed request's latency
    and points, the requests attempted and failed, the window's length,
    and the sampled requests as (index, points, output)."""
    latencies: List[float] = field(default_factory=list)
    points: int = 0
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    sample: List[Tuple[int, torch.Tensor, torch.Tensor]] = field(
        default_factory=list)


class Reservoir:
    """A uniform sample of ``k`` requests of a stream of unknown length,
    drawn from the seed (reservoir sampling).  It holds references to
    the requests' tensors, and copies nothing."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self._rng = random.Random(int(seed))
        self.items: List[Tuple[int, torch.Tensor, torch.Tensor]] = []

    def offer(self, index: int, points, output) -> None:
        if len(self.items) < self.k:
            self.items.append((index, points, output))
            return
        j = self._rng.randrange(index + 1)
        if j < self.k:
            self.items[j] = (index, points, output)


def closed_loop(call: Callable, client: Client, seconds: float,
                sync: Callable[[], None], proceed: Callable[[bool], bool],
                reservoir: Reservoir = None) -> Window:
    """Offer ``client``'s requests to ``call`` one at a time until
    ``proceed(time_left)`` says stop.

    A request's latency runs from the call to the end of its result on
    the device (``sync``), on the host clock; the draw (synchronised
    before the call) and ``proceed`` sit inside the window but outside
    every latency.  The window runs from the first draw to the end of
    the last request, and its points are those of the requests that
    completed.
    """
    w = Window()
    start = time.perf_counter()
    index = 0
    while True:
        points = client.draw()
        sync()
        t0 = time.perf_counter()
        w.attempted += 1
        try:
            out = call(points)
            sync()
        except Exception as exc:  # counted against the attempts
            w.failed += 1
            out = None
            print(f"[bench] request {index} failed: {exc!r}",
                  file=sys.stderr, flush=True)
        t1 = time.perf_counter()
        if out is not None:
            w.latencies.append(t1 - t0)
            w.points += points.shape[0]
            if reservoir is not None:
                reservoir.offer(index, points, out)
        index += 1
        if not proceed(t1 - start < seconds):
            break
    w.seconds = time.perf_counter() - start
    if reservoir is not None:
        w.sample = list(reservoir.items)
    return w
