from .sharded import (  # noqa: F401
    Mesh,
    make_mesh,
    sharded_beam_search,
    sharded_scan_bruteforce,
)
