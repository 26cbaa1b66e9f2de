"""Index memory study — parity with the reference's
experiments/{memory_footprint.py, all_memories.py}: one build per process,
RSS delta around the build, CSV `method,dataset,memory`
(ref: all_memories.py:28-41). On the card the honest number is *device*
memory (the bytes of the index's tensors), so both are reported: host RSS
delta and the exact device footprint of the index's tensors. The CSV column
keeps the JAX package's name, `hbm_bytes`.
"""

from __future__ import annotations

import argparse
import gc
import os
import resource

import torch

from .. import wrapper as wp
from . import datasets as ds


def device_bytes(index) -> int:
    """Bytes of the tensor storages on the index's device that are
    reachable from it (points + graphs). Views share their base's storage,
    so each storage counts once, by its data pointer."""
    device = index.device
    seen, total = set(), 0

    def add(x):
        nonlocal total
        if not isinstance(x, torch.Tensor) or x.device != device:
            return
        st = x.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()

    def walk(obj, depth=0):
        if depth > 4:
            return
        add(obj)
        d = getattr(obj, "__dict__", None)
        if d:
            for v in d.values():
                if isinstance(v, (list, tuple)):
                    for e in v:
                        walk(e, depth + 1)
                else:
                    walk(v, depth + 1)

    walk(index)
    return total


BUILDERS = {
    "prefiltering": lambda m, data, fv, bp, dev: wp.prefilter_index_constructor(m, "float")(data, fv, device=dev),
    "postfiltering": lambda m, data, fv, bp, dev: wp.postfilter_vamana_constructor(m, "float")(data, fv, bp, device=dev),
    "vamana-tree": lambda m, data, fv, bp, dev: wp.vamana_range_filter_tree_constructor(m, "float")(data, fv, build_params=bp, device=dev),
    "super-postfiltering": lambda m, data, fv, bp, dev: wp.super_optimized_postfilter_tree_constructor(m, "float")(data, fv, build_params=bp, device=dev),
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--method", required=True, choices=sorted(BUILDERS))
    p.add_argument("--dataset", required=True)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--build_R", type=int, default=64)
    p.add_argument("--build_L", type=int, default=500)
    p.add_argument("--data_folder", type=str, default=None)
    p.add_argument("--out", default="results/memory.csv")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    data, _, fv, metric = ds.initialize_dataset(args.dataset, args.data_folder)
    bp = wp.BuildParams(args.build_R, args.build_L, args.alpha,
                        f"index_cache/{args.dataset}/")
    gc.disable()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    index = BUILDERS[args.method](metric, data, fv, bp, args.device)
    rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    gc.enable()
    hbm = device_bytes(index)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    new = not os.path.exists(args.out)
    with open(args.out, "a") as f:
        if new:
            f.write("method,dataset,memory,hbm_bytes\n")
        f.write(f"{args.method},{args.dataset},{rss_kb},{hbm}\n")
    print(f"{args.method},{args.dataset}: rss_delta={rss_kb}KB hbm={hbm/1e6:.1f}MB")


if __name__ == "__main__":
    main()
