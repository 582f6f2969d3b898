"""The ranks of a multi-device run: reading a rank's place from its
environment, joining the world, and spawning a world of local ranks.

A rank reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (set by
``torchrun``, or by ``spawn_local``) and joins the world through
``REPRO_TORCH_INIT`` (a ``file://`` rendezvous, which ``spawn_local``
puts in a fresh temporary directory, so that concurrent worlds never
share one) or, without it, ``env://`` (``torchrun``'s ``MASTER_ADDR`` and
``MASTER_PORT``).  A CUDA rank runs on card ``LOCAL_RANK %
device_count()``.  The backend is the caller's: "nccl" needs a card for
each rank and raises otherwise; "gloo" takes CPU ranks, and ranks that
share a card, whose collectives ``core/comm.py`` stages through the host.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence

import torch

# how long a collective may wait for a rank that has died
TIMEOUT_S = 900


class Rank(NamedTuple):
    rank: int
    world: int
    local: int


def rank_env() -> Optional[Rank]:
    """This process's place in a world started by ``torchrun`` or
    ``spawn_local``; None when the environment names none."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return Rank(rank, world, int(os.environ.get("LOCAL_RANK", rank)))


def check_backend(backend: str, device_type: str, world: int) -> None:
    """Raise for a backend that cannot carry ``world`` ranks on
    ``device_type``: NCCL takes CUDA ranks, one card each."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"--backend {backend!r} not in ('gloo', 'nccl')")
    if backend != "nccl":
        return
    if device_type != "cuda":
        raise ValueError("--backend nccl takes CUDA ranks; CPU ranks use "
                         "--backend gloo")
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(
            f"--backend nccl with {world} ranks on {cards} card(s): NCCL "
            "refuses two ranks on one device; ranks that share a card use "
            "--backend gloo")


def device_for(r: Rank, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", r.local % torch.cuda.device_count())
    return torch.device("cpu")


def init_world(r: Rank, backend: str, device: torch.device) -> None:
    """Join the world of ``r`` over ``backend``."""
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=os.environ.get("REPRO_TORCH_INIT", "env://"),
        rank=r.rank, world_size=r.world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)


def spawn_local(cmd: Sequence[str], world: int, *, timeout: float,
                env: Optional[dict] = None, cpu_threads: int = 0,
                workdir: Optional[str] = None) -> List[str]:
    """Run ``cmd`` as ``world`` local ranks (``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK`` and a fresh ``file://`` rendezvous in their
    environment) and wait for all of them.  Returns each rank's standard
    output.  If a rank fails, or the world outlives ``timeout`` seconds,
    every rank still running is killed and RuntimeError carries the
    failing rank's output.  ``cpu_threads`` > 0 sets each rank's
    ``OMP_NUM_THREADS``."""
    src = str(Path(__file__).resolve().parents[2])
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, base.get("PYTHONPATH", "")) if p)
    if cpu_threads:
        base["OMP_NUM_THREADS"] = str(cpu_threads)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        base["REPRO_TORCH_INIT"] = f"file://{tmp}/rendezvous"
        procs, logs = [], []
        try:
            for r in range(world):
                e = dict(base, RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(r))
                out = open(os.path.join(tmp, f"rank{r}.out"), "w+")
                logs.append(out)
                procs.append(subprocess.Popen(list(cmd), env=e, stdout=out,
                                              stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if time.monotonic() > deadline:
                    failed = next(r for r, p in enumerate(procs)
                                  if p.poll() is None)
                    break
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    if failed is not None:
        raise RuntimeError(
            f"rank {failed} of {world} failed (exit {procs[failed].returncode}"
            f"): {' '.join(cmd)}\n{texts[failed][-6000:]}")
    return texts
