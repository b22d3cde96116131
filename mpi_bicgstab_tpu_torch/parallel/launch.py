"""Start the ranks of a distributed run: the port's counterpart of the JAX
package's in-process device mesh (and of `mpirun -np P`).

    run(fn, n, *args, device="cuda")    n ranks run fn(*args); rank 0's
                                        result comes back as host arrays
    with Pool(n, device="cuda") as pool: n ranks that stay up and run
        pool.run(fn, *args)             task after task

As every entry point of the port, both run on the card unless the
caller asks for the CPU (device="cpu", as the tests do), and raise when
fewer than n cards are present.

Each rank is a process started with torch.multiprocessing's "spawn": it
imports torch and this package, nothing of the parent's __main__ beyond
what spawn imports, and sets torch.set_num_threads(1). The ranks meet
through a file:// store in a fresh temporary directory (no TCP port to
collide under parallel test workers) and form one world: gloo for
device="cpu", NCCL for device="cuda", one card per rank (local rank j on
cuda:j). A Pool may also be one node's share of a larger world
(parallel/multihost.py): its ranks then meet the other nodes' at
init_method (tcp://HOST:PORT, the address torchrun's MASTER_ADDR and
MASTER_PORT give), as the global ranks first_rank .. first_rank + n - 1
of world_size. A process that torchrun started (RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT in its environment) joins that world
instead of spawning one: `run` then calls fn in this process
(`torchrun --nproc-per-node 2 -m mpi_bicgstab_tpu_torch solve --devices
2`). fn must be a module-level function of this package, so that a
rank imports nothing but the port; `call_script` runs a function of a
script file instead (a script beside the package, as a smoke run is). A
rank that finds JAX or the JAX package imported after a task fails it.
Every rank calls fn with the same arguments, and fn makes its own grid
(parallel/mesh.py).

A rank that raises reports the error and the parent raises it; the
process group has a timeout, so the others do not wait in a collective
forever.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as _queue
import shutil
import tempfile
import traceback

import numpy as np
import torch

TIMEOUT_S = 300
# modules a rank may run a task from, and the ones it must never import
TASK_MODULES = ("mpi_bicgstab_tpu_torch",)
FORBIDDEN = ("jax", "jaxlib", "mpi_bicgstab_tpu")


def to_host(obj):
    """obj with every tensor replaced by a NumPy array (pairs,
    dataclasses, tuples, lists and dicts walked)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def _check_fn(fn) -> None:
    mod = getattr(fn, "__module__", "") or ""
    if mod.split(".")[0] not in TASK_MODULES:
        raise ValueError(f"{getattr(fn, '__qualname__', fn)!r} is not a "
                         f"function of mpi_bicgstab_tpu_torch: a rank "
                         f"would import {mod or 'its module'}")


def _check_imports() -> None:
    import sys
    bad = sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
    if bad:
        raise RuntimeError(f"a rank imported {bad}")


def _check_devices(n: int, device: str) -> None:
    if device == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > count:
            raise ValueError(f"requested {n} devices, only {count} CUDA "
                             f"device(s) present")
    elif device != "cpu":
        raise ValueError(f"device {device!r}: use 'cuda' or 'cpu'")


def _backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def _init(local: int, rank: int, world: int, init_method: str,
          device: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(local)   # parallel/mesh.py's device
    if device == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(
        _backend(device), init_method=init_method, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def in_torchrun() -> bool:
    """Did torchrun (or an equivalent launcher) start this process as a
    rank of a world?"""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def join_torchrun(n: int, device: str) -> None:
    """Join the world torchrun described in the environment (env://), on
    cuda:LOCAL_RANK or gloo; its size must be n."""
    import torch.distributed as dist
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise ValueError(f"requested {n} ranks, torchrun started {world}")
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    _check_devices(int(os.environ.get("LOCAL_WORLD_SIZE", n)), device)
    if not dist.is_initialized():
        _init(local, int(os.environ["RANK"]), world, "env://", device)


def _worker(local: int, rank: int, world: int, init_method: str,
            device: str, tasks, results):
    """A rank of a Pool: run tasks until the None sentinel."""
    import torch.distributed as dist
    try:
        _init(local, rank, world, init_method, device)
    except Exception:   # noqa: BLE001 — reported to the parent
        results.put((local, False, traceback.format_exc()))
        return
    try:
        while True:
            try:
                task = tasks.get()      # unpickling imports fn's module
                if task is None:
                    break
                fn, args, kwargs = task
                out = fn(*args, **kwargs)
                _check_imports()
                results.put((local, True, to_host(out) if local == 0
                             else None))
            except Exception:   # noqa: BLE001 — reported to the parent
                results.put((local, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Pool:
    """n ranks that run task after task until closed (a context
    manager); run() returns the result of the first of them. By default
    the n ranks are the whole world; with init_method, the global ranks
    first_rank .. first_rank + n - 1 of a world of world_size ranks."""

    def __init__(self, n: int, device: str = "cuda",
                 init_method: str | None = None, first_rank: int = 0,
                 world_size: int | None = None):
        import torch.multiprocessing as mp
        _check_devices(n, device)
        self.n = n
        self._dir = tempfile.mkdtemp(prefix="mbt_launch_")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        if init_method is None:
            init_method = "file://" + os.path.join(self._dir, "store")
        world = n if world_size is None else world_size
        self._procs = [ctx.Process(target=_worker, daemon=True, args=(
            j, first_rank + j, world, init_method, device, self._tasks[j],
            self._results)) for j in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) on every rank; rank 0's result, as host
        arrays. Raises if any rank raised."""
        _check_fn(fn)
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out, errors = None, []
        for _ in range(self.n):
            try:
                rank, ok, payload = self._results.get(
                    timeout=2 * TIMEOUT_S)
            except _queue.Empty:
                raise RuntimeError(f"{fn.__qualname__}: a rank did not "
                                   f"answer in {2 * TIMEOUT_S} s") from None
            if not ok:
                errors.append(f"rank {rank}:\n{payload}")
            elif rank == 0:
                out = payload
        if errors:
            raise RuntimeError(f"{fn.__qualname__} failed on "
                               + "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run(fn, n: int, *args, device: str = "cuda", **kwargs):
    """fn(*args, **kwargs) on n fresh ranks; rank 0's result, as host
    arrays. Under torchrun, this process is one of the n ranks: it joins
    the world, calls fn and returns its own result."""
    _check_fn(fn)
    if in_torchrun():
        import torch.distributed as dist
        join_torchrun(n, device)
        try:
            out = fn(*args, **kwargs)
            _check_imports()
            return to_host(out)
        finally:
            dist.destroy_process_group()
    with Pool(n, device) as pool:
        return pool.run(fn, *args, **kwargs)


def call_script(path: str, name: str, *args, **kwargs):
    """A task that runs the function `name` of the Python file `path`,
    loaded once per rank under its file name, with (*args, **kwargs)."""
    import importlib.util
    import sys
    mod_name = os.path.splitext(os.path.basename(path))[0]
    mod = sys.modules.get(mod_name)
    if mod is None or getattr(mod, "__file__", None) != path:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return getattr(mod, name)(*args, **kwargs)


def result_array(x) -> np.ndarray:
    """A host result's vector (a pair's exact float64 value)."""
    from mpi_bicgstab_tpu_torch.ops.precision import DF
    if isinstance(x, DF):
        return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)
    return np.asarray(x)
