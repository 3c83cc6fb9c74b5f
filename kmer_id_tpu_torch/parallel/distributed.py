"""Multi-process runtime: initialization, health check, sample queue.

Port of ``kmer_id_tpu/parallel/distributed.py`` on ``torch.distributed``:
one process per device, the ranks of one (data x db) grid
(parallel/mesh.py).  :func:`initialize` joins the process group over a TCP
store at the coordinator (NCCL for a CUDA device, gloo for the CPU, unless
told), :func:`health_check` probes the rank's device and runs one
all-reduce as a startup barrier, so a dead peer shows there instead of as a
later mid-batch hang.  :class:`SampleQueue` is a copy of the JAX package's
(its module imports jax): samples are independent, so hosts may also split
a run by claiming samples from a file-locked manifest.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import time

import torch
import torch.distributed as dist

from kmer_id_tpu_torch.utils.logging import log

GROUP_TIMEOUT_S = 1800.0  # a collective that waits longer on a peer raises


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cpu", backend: str | None = None) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``
    (no-op for one process).  ``coordinator`` is ``host:port`` of the TCP
    store, which rank 0 serves; ``backend`` defaults to NCCL for a CUDA
    ``device`` (made this process's current device) and gloo otherwise."""
    if num_processes is None or num_processes <= 1:
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    log(f"distributed up: rank {dist.get_rank()}/{dist.get_world_size()} on {device} "
        f"({backend})")


def health_check(device="cpu") -> dict:
    """Startup barrier + device sanity (the JAX dict): a tiny sum on this
    rank's ``device`` and, with more than one rank, an all-reduce over all
    of them, whose total must be the world size."""
    t0 = time.monotonic()
    dev = torch.device(device)
    try:
        good = int(torch.arange(8, dtype=torch.int32, device=dev).sum()) == 28
    except Exception:
        good = False
    ok = good
    barrier_s = None
    up = dist.is_available() and dist.is_initialized()
    if up and dist.get_world_size() > 1:
        tb = time.monotonic()
        x = torch.ones(1, dtype=torch.int32,
                       device=dev if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(x)
        ok &= int(x) == dist.get_world_size()
        barrier_s = round(time.monotonic() - tb, 3)
    return {
        "host": socket.gethostname(),
        "process": dist.get_rank() if up else 0,
        "devices": {str(dev): good},
        "ok": ok,
        "barrier_s": barrier_s,
        "probe_s": round(time.monotonic() - t0, 3),
    }


class SampleQueue:
    """File-locked work queue of independent samples (restartable)."""

    def __init__(self, manifest_path: str, samples: list[str]):
        self.path = manifest_path
        self.samples = samples
        if not os.path.exists(manifest_path):
            # take the lock: concurrent workers may race to create the
            # manifest (observed as a vanished .tmp under os.replace)
            lock = self.path + ".lock"
            for _ in range(100):
                try:
                    fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    break
                except FileExistsError:
                    time.sleep(0.05)
            else:
                raise TimeoutError("manifest lock")
            try:
                if not os.path.exists(manifest_path):
                    self._write({"pending": samples, "done": [], "claimed": {}})
            finally:
                os.close(fd)
                os.unlink(lock)

    def _read(self) -> dict:
        with open(self.path) as f:
            return json.load(f)

    def _write(self, state: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, self.path)

    def claim(self, worker: str) -> str | None:
        """Claim the next pending sample (atomic via rename)."""
        lock = self.path + ".lock"
        for _ in range(100):
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                time.sleep(0.05)
        else:
            return None
        try:
            state = self._read()
            if not state["pending"]:
                return None
            sample = state["pending"].pop(0)
            state["claimed"][sample] = {"worker": worker, "t": time.time()}
            self._write(state)
            return sample
        finally:
            os.close(fd)
            os.unlink(lock)

    def complete(self, sample: str) -> None:
        lock = self.path + ".lock"
        for _ in range(100):
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                break
            except FileExistsError:
                time.sleep(0.05)
        else:
            raise TimeoutError("manifest lock")
        try:
            state = self._read()
            state["claimed"].pop(sample, None)
            if sample not in state["done"]:
                state["done"].append(sample)
            self._write(state)
        finally:
            os.close(fd)
            os.unlink(lock)

    def reclaim_stale(self, timeout_s: float = 3600.0) -> list[str]:
        """Requeue samples whose worker went silent (elastic recovery)."""
        state = self._read()
        now = time.time()
        stale = [s for s, c in state["claimed"].items() if now - c["t"] > timeout_s]
        if stale:
            for s in stale:
                state["claimed"].pop(s)
                state["pending"].insert(0, s)
            self._write(state)
        return stale
