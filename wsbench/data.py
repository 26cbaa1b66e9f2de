"""Points, labels and the traffic's pool of batches, made from the seed.

The configuration's `data.generator` names a file of its own,
generators/<name>.py, whose `make` draws the points, labels and queries on
the device with the run's one torch.Generator in a few large calls. The
traffic file gives the pool: `pool` batches of `batch` queries, each query
with a window of width `fraction` x range at a uniform start, drawn here
after the generator's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Data:
    points: np.ndarray  # [n, d] float32
    labels: np.ndarray  # [n] float64
    queries: np.ndarray  # [pool, batch, d] float32
    filters: np.ndarray  # [pool, batch, 2] float64 label windows (lo, hi)


def generate(config: dict, traffic: dict, seed: int, generator, device="cuda") -> Data:
    """The cell's data from `seed`; `generator` is the module that
    config["data"]["generator"] names (catalog.Cell.generator)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pool, batch = int(traffic["pool"]), int(traffic["batch"])
    points, labels, queries = generator.make(config, pool, batch, gen, device)
    frac = float(traffic["fraction"])
    lo = torch.rand(pool, batch, generator=gen, dtype=torch.float64,
                    device=device) * (1.0 - frac)
    filters = torch.stack([lo, lo + frac], dim=-1)
    out = Data(points=points.cpu().numpy(), labels=labels.cpu().numpy(),
               queries=queries.cpu().numpy(), filters=filters.cpu().numpy())
    del points, labels, queries, filters
    return out
