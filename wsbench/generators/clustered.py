"""Clustered Gaussian points and queries (bench.py's shape): cluster centres
drawn from N(0, 1), each point and query a random centre plus isotropic
noise, labels uniform in [0, 1).

Parameters, under the configuration's `data`: `clusters`, `noise`, and
`labels` ("uniform", the only distribution this generator draws).
"""

import torch


def make(config: dict, pool: int, batch: int, gen: torch.Generator, device):
    """(points [n, d] float32, labels [n] float64, queries [pool, batch, d]
    float32), drawn from `gen` on `device` in a few large calls."""
    n, d = int(config["n"]), int(config["d"])
    g = config["data"]
    if g["labels"] != "uniform":
        raise ValueError(f"the clustered generator draws uniform labels, not {g['labels']!r}")
    clusters, noise = int(g["clusters"]), float(g["noise"])
    centers = torch.randn(clusters, d, generator=gen, device=device)
    assign = torch.randint(0, clusters, (n,), generator=gen, device=device)
    points = torch.randn(n, d, generator=gen, device=device).mul_(noise)
    points += centers[assign]
    del assign
    labels = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    q_assign = torch.randint(0, clusters, (pool, batch), generator=gen, device=device)
    queries = torch.randn(pool, batch, d, generator=gen, device=device).mul_(noise)
    queries += centers[q_assign]
    return points, labels, queries
