"""The one traffic generator. A traffic file (traffic/<name>.json) gives

    "request":    the SDK call a request makes ("prove": ProverClient.prove)
    "guest_args": the guest's sizes, over the configuration's own
    "loop":       "closed": one request at a time, the next sent when the last returns
    "clients":    1

and each request's stdin comes from the guest's `inputs(rng, **args)`, with
rng seeded by (seed, request index): request -1 is set-up's warm request,
0, 1, .. the window's. The same seed gives the same inputs."""

from __future__ import annotations

import numpy as np

REQUESTS = ("prove",)


class Traffic:
    def __init__(self, cell, seed: int):
        self.cell = cell
        self.seed = int(seed) % (1 << 64)
        t = cell.traffic
        if t.get("request") not in REQUESTS:
            raise ValueError(f"{cell.name}: request {t.get('request')!r} is not one of {REQUESTS}")
        if t.get("loop", "closed") != "closed" or int(t.get("clients", 1)) != 1:
            raise ValueError(f"{cell.name}: only a closed loop of one client is generated")
        self.kind = t["request"]
        self.args = cell.guest_args()
        self.guest = cell.guest()

    def inputs(self, i: int) -> list:
        return self.guest.inputs(np.random.default_rng([self.seed, i + 1]), **self.args)
