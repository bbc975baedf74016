"""Process groups for multi-device execution over torch.distributed
(counterpart of flexflow_tpu/runtime/distributed.py `initialize`,
`shutdown` and `host_info`).

The JAX package runs one program over a mesh of devices and lets GSPMD
place the collectives; the port runs one process per mesh position
(core/machine.py) and writes the collectives out
(runtime/collectives.py). `initialize` joins the process group once per
process and fixes, once:

 - the rank's device: `cuda:(local_rank % device_count)` for "cuda", or
   the CPU for "cpu";
 - the backend: NCCL when every rank of the host has a card of its own
   (local world size <= device count), gloo otherwise: on the CPU, and on
   a machine whose ranks share one card. Under gloo with CUDA tensors,
   runtime/collectives.py stages each collective's tensor through host
   memory explicitly (counted there). The rule is decided here and
   printed, never reached by catching an NCCL error.

`spawn` starts the ranks of one machine as fresh processes (the spawn
method) and collects what each returns, with one time limit for all.
"""
from __future__ import annotations

import datetime
import os
import queue
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# this process's membership: torch.distributed's default group is
# process-wide, and so is what initialize decided beside it
_STATE: Optional[Dict[str, Any]] = None


def backend_for(device_type: str, local_world: int) -> str:
    """NCCL when each of the host's `local_world` ranks has a card of its
    own, gloo otherwise."""
    if device_type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None, device: str = "cuda",
               timeout_s: float = 600.0) -> Dict[str, Any]:
    """Join the process group (idempotent) and return `host_info()`.

    Arguments left None come from the launcher's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE; init_method "env://" reads
    MASTER_ADDR / MASTER_PORT). Nothing tells a program of a cluster
    otherwise: give the address (`tcp://localhost:<port>` or
    `file://<path>`), the world size and the rank. `device` is "cuda" (the
    default: the rank's card, which must exist) or "cpu"."""
    global _STATE
    if _STATE is not None:
        return host_info()
    env = os.environ
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local = int(local_rank if local_rank is not None
                else env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device "
                               "visible; pass device='cpu' to run the ranks "
                               "on the CPU")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif device == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    backend = backend_for(dev.type, local_world)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _STATE = {"backend": backend, "device": dev, "local_rank": local,
              "host_staging": backend == "gloo" and dev.type == "cuda"}
    if rank == 0:
        print(f"flexflow_tpu_torch.distributed: {world} ranks, backend "
              f"{backend}, rank 0 on {dev}"
              + (", collectives staged through host memory"
                 if _STATE["host_staging"] else ""), file=sys.stderr,
              flush=True)
    return host_info()


def is_initialized() -> bool:
    return _STATE is not None and dist.is_initialized()


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    global _STATE
    if _STATE is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None


def device() -> torch.device:
    """This rank's device, as initialize chose it."""
    if _STATE is None:
        raise RuntimeError("torch.distributed is not initialized "
                           "(flexflow_tpu_torch.runtime.distributed."
                           "initialize)")
    return _STATE["device"]


def host_staging() -> bool:
    """True when collectives of CUDA tensors go through host memory (gloo
    on a card)."""
    return bool(_STATE and _STATE["host_staging"])


def host_info() -> Dict[str, Any]:
    """This process's place: rank, world size, local devices, backend,
    device and whether collectives are staged through host memory."""
    if _STATE is None:
        return {"process_id": 0, "process_count": 1,
                "local_devices": torch.cuda.device_count(),
                "backend": None, "device": None, "host_staging": False}
    return {"process_id": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_rank": _STATE["local_rank"],
            "local_devices": torch.cuda.device_count(),
            "backend": _STATE["backend"], "device": str(_STATE["device"]),
            "host_staging": _STATE["host_staging"]}


def _run_rank(fn, rank: int, args: Sequence, results) -> None:
    # every rank of `spawn` is on this machine: gloo meets over loopback,
    # whatever the host name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        out = fn(rank, *args)
    except BaseException:  # reported to the parent, then this rank exits 1
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          timeout_s: float = 120.0) -> List[Any]:
    """Run fn(rank, *args) in `nprocs` fresh processes (the spawn method)
    and return their results by rank. `fn` must be importable by name and
    its results picklable. Raises RuntimeError with the traceback when a
    rank fails, and TimeoutError when any is still running after
    `timeout_s`; either way every rank is stopped before it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_run_rank, args=(fn, r, tuple(args), results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    failed: Dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    try:
        # drain the queue before any join: a child's feeder thread cannot
        # finish (and the child exit) while its result is unread
        while len(got) + len(failed) < nprocs and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    time.sleep(0.5)  # a dying rank's report may be in flight
                    if results.empty():
                        break
                continue
            (got if ok else failed)[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=5.0 if (failed or len(got) < nprocs) else 60.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{failed[rank]}")
    if len(got) < nprocs:
        missing = sorted(set(range(nprocs)) - set(got))
        codes = {r: procs[r].exitcode for r in missing}
        if time.monotonic() >= deadline:
            raise TimeoutError(f"ranks {missing} of {nprocs} still running "
                               f"after {timeout_s} s; stopped")
        raise RuntimeError(f"ranks {missing} of {nprocs} exited without a "
                           f"result (exit codes {codes})")
    return [got[r] for r in range(nprocs)]
