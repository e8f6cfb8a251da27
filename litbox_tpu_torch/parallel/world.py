"""Ranks, meshes and per-rank generators on torch.distributed.

The JAX package runs one program over a device mesh in one process
(`shard_map`); torch.distributed runs one process per rank. `run` is the
counterpart of JAX's SPMD launch: it starts the ranks, joins them and
returns what each returned. Every rank calls the parallel functions with
its own local block.

    results = world.run(fn, n, arg)                # NCCL, rank r on cuda:r
    results = world.run(fn, 4, arg, device="cpu")  # gloo on the CPU

The device is "cuda" by default, as for every entry point of the port.
The backend is gloo on the CPU and NCCL on CUDA; there is no fallback from
one to the other: a world on "cuda" needs a visible card a rank, or `run`
raises before it starts any. Ranks rendezvous through a `file://` store in a fresh
temporary directory, so that concurrent worlds never compete for a port.
`init_process_group` and the join both have a timeout, so a hung
collective fails the call instead of hanging it.

A mesh covers the first n ranks of the world, laid out row-major as the
JAX package's `Mesh(devices[:n].reshape(shape))`; every rank of the world
must build it (group creation is collective), and a rank outside it has no
coordinate. `axis` gives a rank its group, size and index on one mesh
dimension, the counterpart of `jax.lax.axis_size` / `axis_index`.
"""

from __future__ import annotations

import datetime
import multiprocessing
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 300.0  # seconds, for the process group and for the join


def backend_for(device: str) -> str:
    """gloo for "cpu", NCCL for "cuda"."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no torch.distributed backend for device {device!r}")
    return "nccl" if kind == "cuda" else "gloo"


def rank_device() -> torch.device:
    """This rank's device: its card under NCCL (the current device, which
    `init` set), else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init(rank: int, world_size: int, store: str, device: str = "cuda",
         timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the world as `rank` through the file store at `store`. On CUDA
    the rank's card becomes the current device first, so the kernels'
    libraries and NCCL run on it."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend_for(device), init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def _child(fn, rank, world_size, store, device, timeout, out_dir) -> None:
    """A spawned rank: join, run fn(*args) with the run's arguments, save
    its result, leave. A failure is written as its traceback and the rank
    exits with 1."""
    out = Path(out_dir)
    torch.set_num_threads(1)
    try:
        args = torch.load(out / "args.pt", weights_only=False)
        (out / f"ready_{rank}").touch()
        init(rank, world_size, store, device, timeout)
        try:
            torch.save(fn(*args), out / f"result_{rank}.pt")
        finally:
            dist.destroy_process_group()
    except Exception:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


def run(fn, world_size: int, *args, device: str = "cuda",
        timeout: float = DEFAULT_TIMEOUT, inline_rank0: bool = False) -> list:
    """Run fn(*args) on `world_size` ranks; returns each rank's result, by
    rank.

    Ranks are started with `spawn` (never `fork`: the caller may hold
    threads), so fn must be importable by name and the results picklable.
    With inline_rank0, rank 0 runs in this process (its launches count in
    this process's counters) and only ranks 1.. are spawned. Raises
    RuntimeError with the failing ranks' tracebacks, or TimeoutError when a
    rank has not ended `timeout` seconds after the start; every process it
    started has ended when it returns or raises. On "cuda" with fewer
    visible cards than ranks it raises RuntimeError and starts none."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if backend_for(device) == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world_size:
            raise RuntimeError(f"a world of {world_size} ranks on {device!r} needs "
                               f"{world_size} CUDA devices, {cards} visible "
                               "(device='cpu' runs the ranks on the host with gloo)")
    tmp = Path(tempfile.mkdtemp(prefix="litbox_world_"))
    store = str(tmp / "store")
    ctx = multiprocessing.get_context("spawn")
    procs = {r: ctx.Process(target=_child, args=(fn, r, world_size, store, device,
                                                  timeout, str(tmp)))
             for r in range(1 if inline_rank0 else 0, world_size)}
    if procs:
        # The arguments go through a file: a spawned child reads its Process
        # object only after importing its parent's main module, so large
        # arguments in the pipe would make each start() wait for that import.
        torch.save(args, tmp / "args.pt")
    deadline = time.monotonic() + timeout
    try:
        for p in procs.values():
            p.start()
        results = {}
        if inline_rank0:
            # Rank 0 joins once every spawned rank has started: one that
            # failed to start would leave it at the rendezvous until the
            # timeout.
            _wait(procs, tmp, deadline, lambda: all(
                (tmp / f"ready_{r}").exists() for r in procs))
            init(0, world_size, store, device, timeout)
            try:
                results[0] = fn(*args)
            finally:
                dist.destroy_process_group()
        _wait(procs, tmp, deadline, lambda: not any(p.is_alive() for p in procs.values()))
        for r in procs:
            results[r] = torch.load(tmp / f"result_{r}.pt", weights_only=False)
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
            p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)


def _wait(procs: dict, tmp: Path, deadline: float, done) -> None:
    """Poll the spawned ranks until done() holds. A rank that failed leaves
    the others waiting in a collective, so the first failure raises
    RuntimeError with every failed rank's traceback (after a moment for the
    others to fail in turn); the deadline raises TimeoutError."""
    while True:
        if any(p.exitcode not in (None, 0) for p in procs.values()):
            grace = min(time.monotonic() + 10.0, deadline)
            for p in procs.values():
                p.join(max(0.0, grace - time.monotonic()))
            failed = {r: p.exitcode for r, p in procs.items()
                      if p.exitcode not in (None, 0)}
            raise RuntimeError("\n".join(
                f"rank {r} exited with {code}:\n" + (
                    (tmp / f"error_{r}.txt").read_text()
                    if (tmp / f"error_{r}.txt").exists() else "(no traceback)")
                for r, code in sorted(failed.items())))
        if done():
            return
        if time.monotonic() > deadline:
            hung = sorted(r for r, p in procs.items() if p.is_alive())
            raise TimeoutError(f"ranks {hung} still ran at the deadline")
        time.sleep(0.05)


def build_mesh(n_devices: int | None, shape: tuple, names: tuple):
    """A DeviceMesh of `shape` over ranks 0 .. n-1 (n = n_devices, or the
    world), row-major: the mesh init_device_mesh builds over the whole
    world, here over its first n ranks, as the JAX package takes
    jax.devices()[:n]. The device type follows the backend."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"{n} devices asked of a world of {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(shape), mesh_dim_names=names)


def axis(mesh, name: str) -> tuple:
    """(process group, size, this rank's index) of mesh dimension `name`."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(name), mesh.shape[dim], mesh.get_local_rank(name)


def mesh_shape(mesh) -> dict:
    """{dimension name: size}, as a JAX Mesh's `shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def derive_generator(generator: torch.Generator, index: int, count: int) -> torch.Generator:
    """The generator of row or rank `index` of `count`: the counterpart of
    jax.random.split(key, count)[index] and of fold_in(key, index).

    Draws `count` seeds from `generator` with one randint call and seeds a
    new generator on the caller's generator's device with seed `index`. Every rank that calls it with the same base state gets
    the same seeds, and a caller can repeat the call to build the generator
    that a row or rank used. The base generator moves on by one draw."""
    seeds = torch.randint(0, 2**62, (count,), generator=generator,
                          device=generator.device)
    out = torch.Generator(device=generator.device)
    return out.manual_seed(int(seeds[index]))


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Stack x of every rank of `group`, in group order: (n, ...)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)
