"""Row-sharded execution over a torch.distributed process group (port of
rpagp/parallel/): comm.py (the collectives), sharding.py (the mesh and
the distributed paths), dist_chol.py (the banded grid factor),
multihost.py (the process layer) and launch.py (local CPU worlds)."""
