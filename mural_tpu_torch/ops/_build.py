"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface.  At first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library in
``build/kernels/`` at the root of the checkout and loaded with
``ctypes``; the library is rebuilt when it is missing or older than its
source or one of the headers (``csrc/*.cuh``) the sources share.
Nothing here runs at import time, so CPU-only machines import the kernel
modules freely.

Each kernel module keeps its launch counters as module attributes (plain
ints that callers read, and reset to 0 to count a run); the module
counts a launch through :func:`count_launches`, which defers a launch
that a CUDA graph records to each replay of the graph
(:func:`captured_launches`, :func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes argument types: every pointer and the stream as c_void_p, every
# int as c_int, row strides as c_longlong
PTR, INT, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_COUNT_LOCK = threading.Lock()
# capture stream -> {(module, counter): launches recorded on it}; keyed by
# stream, not thread, because autograd runs backward kernels on its own
# device thread
_CAPTURED: Dict[int, Dict] = {}


class KernelLibrary:
    """One ``csrc/<name>.cu`` file, built and loaded once per process.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every function returns a ``cudaError_t`` (0 on success)."""

    def __init__(self, name: str, signatures: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._lib is not None:
                return self._lib
            so = BUILD_DIR / f"lib{self.name}.so"
            newest = max(p.stat().st_mtime
                         for p in (self.source, *CSRC.glob("*.cuh")))
            if not so.exists() or so.stat().st_mtime < newest:
                self.build_log = self._build(so)
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
            return lib

    def _build(self, so: Path) -> str:
        """Compile the source into ``so``; returns nvcc's output (register
        and shared-memory use from ``-Xptxas -v``)."""
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"{self.name}: nvcc not found (needed to "
                               f"build {self.source.name} for CUDA tensors)")
        return build_shared([nvcc, *NVCC_FLAGS], self.source, so)


def build_shared(command: Sequence[str], source: Path, so: Path) -> str:
    """Run ``command -o <tmp> source`` and rename ``<tmp>`` to ``so``;
    returns the compiler's output and raises with its errors.  The
    temporary name is unique to the call, so concurrent builds (threads
    or processes) never load a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        res = subprocess.run([*command, "-o", tmp, str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(command[0])} failed on "
                               f"{source}:\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return res.stdout + res.stderr


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def current_stream(t) -> int:
    """The raw ``cudaStream_t`` of torch's current stream on ``t``'s card:
    ``torch.cuda.current_stream(t.device).cuda_stream``, read without
    building a Stream object."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch(fn, device, *args) -> int:
    """Call the C launcher ``fn(*args)`` with ``device`` (the tensors')
    as the thread's current device: the launch, and the kernel's
    shared-memory attribute, which CUDA keeps per device, go to that card
    whatever card the calling thread had current (a replica or a rank on
    ``cuda:1``); where it is current already, the launcher is called
    without entering ``torch.cuda.device``.  Returns the launcher's
    ``cudaError_t``."""
    import torch
    if torch.cuda.is_initialized() and \
            device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def add_launches(tally: Dict) -> None:
    """Add ``tally``'s ``{(module, counter): n}`` launches to the
    counters (a graph's replay adds the launches it recorded)."""
    with _COUNT_LOCK:
        for (module, counter), n in tally.items():
            setattr(module, counter, getattr(module, counter) + n)


def count_launches(module, counter: str, n: int, stream: int) -> None:
    """Count ``n`` launches made on ``stream`` in ``module``'s attribute
    ``counter``: into the capture's tally while a CUDA graph records the
    stream (a capture runs nothing), else at once."""
    tally = _CAPTURED.get(stream)
    if tally is None:
        add_launches({(module, counter): n})
    else:
        key = (module, counter)
        tally[key] = tally.get(key, 0) + n


@contextlib.contextmanager
def captured_launches(stream: "torch.cuda.Stream"):
    """While a CUDA graph captures ``stream``, collect the launches made
    on it into the yielded ``{(module, counter): n}`` tally instead of the
    counters; each replay of the graph adds the tally
    (:func:`add_launches`)."""
    tally = {}
    _CAPTURED[stream.cuda_stream] = tally
    try:
        yield tally
    finally:
        del _CAPTURED[stream.cuda_stream]
