"""Build and load the hand-written CUDA kernels of ``kernels/csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` into ``build/repro_torch_kernels/<name>-<hash>.so`` at the
root of the checkout (a directory ``.gitignore`` lists), then loaded with
``ctypes``.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused.  ``build()`` starts one ``nvcc``
per stale source, all at once, and waits for all of them.  A missing
``nvcc`` or a failed compile raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _target(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, every shared
    header of ``csrc/`` (a source may include any of them) and the
    flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch are compiled at first use on a "
            "machine with the CUDA toolkit")
    return exe


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the stale sources among ``names`` (default: every
    ``csrc/*.cu``) in parallel.  Returns ``{name: nvcc output}`` for the
    sources compiled by this call (ptxas reports registers, shared memory
    and spills per kernel); raises RuntimeError if any compile fails."""
    srcs = ([CSRC / f"{n}.cu" for n in names] if names is not None
            else sorted(CSRC.glob("*.cu")))
    todo = [(s, _target(s)) for s in srcs if not _target(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_name(f"{out.name}.log")
        with open(log, "w") as fh:
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                     str(src)], stdout=fh,
                                    stderr=subprocess.STDOUT)
        jobs.append((src, out, tmp, log, proc))
    logs, errors = {}, []
    for src, out, tmp, log, proc in jobs:
        code = proc.wait()
        text = log.read_text()
        if code == 0:
            os.replace(tmp, out)
            logs[src.stem] = text
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{src.name}: nvcc exited {code}\n{text}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if stale."""
    build([name])
    return ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))


def on_cuda(kernel: str, *tensors: Optional[torch.Tensor]) -> bool:
    """Route one call: True when every tensor lies on one CUDA device (the
    kernel runs), False when every tensor lies on the CPU (the plain
    version runs) or every one is a meta tensor: the dry run
    (``launch/dryrun.py``) traces a rank's step on meta tensors, where
    the plain version computes shapes and dtypes only and no data.
    Anything else raises (tensors on several devices, any other
    device): a kernel never falls back."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {devs}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{kernel}: tensors on {dev}; the kernel takes CUDA "
                     "tensors and its plain version CPU tensors")


@functools.cache
def sm_count(index: Optional[int]) -> int:
    """The SM count of CUDA device ``index`` (None: the current one)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_launch(kernel: str, err: int):
    """Raise if the C launcher reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{err}")
