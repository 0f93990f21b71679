"""A local world of CPU ranks in one call: `run_world(fn, world)` starts
`world` processes, joins them in one gloo process group over a FileStore,
runs fn(mesh, *args) on each and returns the ranks' results in rank
order. The port's tests drive the parallel path at 2 and 4 ranks with
it, and it is the quickest dry run of that path on a machine with no
card:

    from rpagp_torch.parallel import launch
    launch.run_world(my_fn, 4, comp=2)   # a 2 x 2 data x comp mesh

`fn` must be importable by the child processes (a module-level function
of a module whose import is light). Each rank runs one thread. A rank
that raises fails the call with its traceback; a world that has not
ended after `timeout_s` seconds is killed and the call raises, and a
collective waits at most `collective_timeout_s` seconds.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback


def _rank_main(rank, world, comp, tmp, collective_timeout_s):
    import torch
    import torch.distributed as dist

    from . import multihost, sharding

    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}")
    try:
        # the call comes through a file: a large argument written down a
        # spawned process's pipe would hold each start until it had booted
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        multihost.initialize(device="cpu", timeout_s=collective_timeout_s,
                             store=dist.FileStore(os.path.join(tmp, "store"),
                                                  world),
                             rank=rank, world_size=world)
        result = fn(sharding.make_mesh(comp=comp), *args)
        with open(out + ".pkl", "wb") as f:
            pickle.dump(result, f)
        multihost.shutdown()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(fn, world: int, args=(), comp: int = 1,
              timeout_s: float = 120.0, collective_timeout_s: float = 60.0):
    """[fn(mesh, *args) on rank r for r in range(world)] over gloo, each
    rank a spawned process on the CPU; a (world // comp) x comp mesh."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, comp, tmp, collective_timeout_s),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            # a rank that fails ends the world: the others would wait on
            # its collectives until they time out
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world} ranks ran past "
                                       f"{timeout_s} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if errors:
            raise RuntimeError("\n".join(errors))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
