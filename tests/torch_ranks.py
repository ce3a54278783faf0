"""The rank pool of the port's multi-rank CPU tests: spawned processes in
one gloo group (rendezvous through a file), each running task functions of
a test module (imported by name in the rank) on request. A test sends one
task to every rank and waits at most DEADLINE s for all of them; past it,
or when a rank fails, the ranks are killed and the test fails, so a hung
collective costs one test its deadline and no more. The module imports no
JAX, so a pool whose tasks live in a JAX-free module starts without it.
"""

import importlib
import multiprocessing as mp
import queue
import time
import traceback

import pytest
import torch
import torch.distributed as dist

from univid_tpu_torch.core.mesh import MeshSpec, make_mesh

DEADLINE = 120   # seconds a test's ranks may take, start-up included


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

_MESHES = {}


def _mesh(**axes):
    """This rank's cpu DeviceMesh of MeshSpec(**axes), made once."""
    spec = MeshSpec(**axes)
    if spec not in _MESHES:
        _MESHES[spec] = make_mesh(spec, device="cpu")
    return _MESHES[spec]


def _serve(rank, world, init, inbox, outbox):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        outbox.put((rank, True, "ready"))
    except Exception:
        outbox.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = inbox.get()
        if task is None:
            break
        module, name, args = task
        try:
            fn = getattr(importlib.import_module(module), name)
            with torch.no_grad():
                out = fn(rank, world, *args)
            outbox.put((rank, True, out))
        except Exception:
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class Ranks:
    """`world` spawned processes in one gloo group, each running task
    functions (of this module or another test module) on request, under
    no_grad (a training task enables grad itself)."""

    def __init__(self, world, tmpdir):
        ctx = mp.get_context("spawn")
        self.world = world
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        init = f"file://{tmpdir}/rendezvous"
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, init, self.inboxes[r],
                                        self.outbox))
                      for r in range(world)]
        self.alive = True
        for p in self.procs:
            p.start()
        self._collect("start-up", time.monotonic() + DEADLINE)

    def _collect(self, what, end):
        got = {}
        while len(got) < self.world:
            try:
                rank, ok, out = self.outbox.get(
                    timeout=max(0.1, end - time.monotonic()))
            except queue.Empty:
                self.kill()
                late = sorted(set(range(self.world)) - set(got))
                pytest.fail(f"{what}: ranks {late} passed the {DEADLINE} s "
                            "deadline")
            if not ok:
                self.kill()
                pytest.fail(f"{what} failed on rank {rank}:\n{out}")
            got[rank] = out
        return [got[r] for r in range(self.world)]

    def run(self, task, *args):
        """task(rank, world, *args) on every rank: the list of results."""
        end = time.monotonic() + DEADLINE
        for box in self.inboxes:
            box.put((task.__module__, task.__name__, args))
        return self._collect(task.__name__, end)

    def kill(self):
        self.alive = False
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(5)

    def close(self):
        if self.alive:
            for box in self.inboxes:
                box.put(None)
            for p in self.procs:
                p.join(10)
        self.kill()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pools = {}

    def get(world):
        if world not in pools or not pools[world].alive:
            pools[world] = Ranks(world, tmp_path_factory.mktemp(f"g{world}"))
        return pools[world]

    yield get
    for pool in pools.values():
        pool.close()
