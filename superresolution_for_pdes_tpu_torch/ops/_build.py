"""The host side of the hand-written CUDA kernels (``csrc/*.cu``): their
build and load, the launch helpers and the one registry of launch counts.

Each source is compiled by ``nvcc`` into its own shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). All sources compile at once, one ``nvcc`` process each. Libraries are
cached by a hash of the sources and flags under ``build/torch_kernels/`` at the
repository root, so a second process reuses them. Only sources in this
package's ``csrc/`` are built.

The build runs at the first kernel call on a CUDA tensor; nothing here runs at
import time.

A wrapper counts its launches by dtype (:func:`count_launch`); a kernel
module reads and resets its own wrappers' counts, and a CUDA graph's replay
advances every module's (:func:`launch_tally`, :func:`add_launches`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterable, Mapping, NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "--fmad=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)


class Build(NamedTuple):
    libraries: dict[str, Path]  # {source stem: shared library}
    seconds: float
    log: dict[str, str]         # {source stem: nvcc output} for what was compiled


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
                       "default /usr/local/cuda/bin); it is needed to build "
                       f"the kernels in {CSRC}")


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256()
    for part in sorted(CSRC.glob("*.cuh")) + [src]:
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Build:
    """Compile every ``csrc/*.cu`` not yet cached. Raises with the compiler's
    output if any build fails."""
    t0 = time.perf_counter()
    libs = {src.stem: _library_path(src) for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: so for stem, so in libs.items() if not so.exists()}
    logs = {}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for stem, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            procs.append((stem, proc, tmp, so, cmd))
        failures = []
        for stem, proc, tmp, so, cmd in procs:
            out, _ = proc.communicate()
            logs[stem] = out
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return Build(libs, time.perf_counter() - t0, logs)


@functools.lru_cache(maxsize=None)
def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    return ctypes.CDLL(str(build_all().libraries[stem]))


# ------------------------------------------------------------------ launching
def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """``t``'s device address for a C entry point (``NULL`` for ``None``)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _on(t: torch.Tensor):
    """``t``'s device made current for a launch, unless it already is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def launch(wrapper: Callable, entry: Callable, t: torch.Tensor, *args,
           dtype: torch.dtype = torch.float32) -> None:
    """``entry(*args, stream)``, a C entry point, on ``t``'s device and its
    current stream; raises on the cudaError it returns, else counts one
    launch of ``wrapper``'s kernel for ``dtype``."""
    with _on(t):
        code = entry(*args, ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream))
    if code != 0:
        raise RuntimeError(f"{wrapper.__module__}.{wrapper.__name__}: CUDA kernel launch "
                           f"failed with cudaError {code}")
    count_launch(wrapper, dtype)


# --------------------------------------------------------------- launch counts
_LAUNCHES: collections.Counter = collections.Counter()  # {(wrapper, dtype): launches}


def count_launch(wrapper: Callable, dtype: torch.dtype = torch.float32) -> None:
    """One launch by ``wrapper`` of its kernel instantiated for ``dtype``."""
    _LAUNCHES[wrapper, dtype] += 1


def launch_counts(wrappers: Iterable[Callable],
                  dtype: torch.dtype = torch.float32) -> dict[str, int]:
    """Launches of each of ``wrappers`` for ``dtype`` since its last reset,
    by name."""
    return {fn.__name__: _LAUNCHES[fn, dtype] for fn in wrappers}


def reset_launch_counts(wrappers: Iterable[Callable]) -> None:
    """Zero every count of ``wrappers``."""
    wrappers = set(wrappers)
    for key in [key for key in _LAUNCHES if key[0] in wrappers]:
        del _LAUNCHES[key]


def launch_tally() -> collections.Counter:
    """Every kernel module's counts (two tallies' difference: the launches between)."""
    return collections.Counter(_LAUNCHES)


def add_launches(delta: Mapping) -> None:
    """Advance the counts by a difference of two :func:`launch_tally` s (or its
    negation): a graph's replay runs the launches its capture counted."""
    _LAUNCHES.update(delta)
