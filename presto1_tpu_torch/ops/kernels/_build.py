"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` (the hash is
of the source text, so an edited source never meets a stale library), then
loaded with ``ctypes``.  Nothing is built when the package is imported, and
nothing falls back: without ``nvcc`` or with a source that does not compile,
the first use raises with the compiler's output.

``build_all()`` starts one ``nvcc`` per source at once, for callers that want
every kernel ready before they begin.  ``sm_count(device)`` is the device's
number of streaming multiprocessors and ``l2_bytes(device)`` its L2 cache
size, each looked up once per device: the wrappers size their grids by them
on every call.  ``launch_on(device, launch)`` calls ``launch(stream)`` with
the raw handle of the device's current stream, and makes the device current
for the call only where it is not already.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# one build and load at a time in a process: two threads reaching a kernel
# first together (a worker's task threads) would otherwise both start nvcc
# on the same temporary file
_LOAD_LOCK = threading.Lock()
_SMS: Dict[int, int] = {}
_L2: Dict[int, int] = {}
# name -> {"seconds": wall time of the nvcc run (0.0 if the library was
# already there), "log": what nvcc printed (registers, spills), "path": .so}
BUILD_INFO: Dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked at $NVCC, PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin): the CUDA kernels of this package are built "
        "from source on first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Optional[tuple]:
    """Start nvcc for one source; None when its library is already built."""
    out = _target(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "",
                                     "path": str(out)})
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, out, time.time()


def _finish(name: str, started: tuple) -> None:
    proc, cmd, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise KernelBuildError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build wins or loses whole
    BUILD_INFO[name] = {"seconds": time.time() - t0, "log": log,
                        "path": str(out)}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, dict]:
    """Build every kernel source, all compilers started together."""
    started = {name: _start(name) for name in sources()}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)
    return {name: BUILD_INFO[name] for name in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                st = _start(name)
                if st is not None:
                    _finish(name, st)
                lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device:
    ``torch.cuda.get_device_properties`` costs microseconds a call)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def l2_bytes(device: torch.device) -> int:
    """Bytes of a CUDA device's L2 cache (cached per device)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    size = _L2.get(index)
    if size is None:
        size = _L2[index] = \
            torch.cuda.get_device_properties(index).L2_cache_size
    return size


def launch_on(device: torch.device, launch):
    """``launch(stream)`` with the raw handle of ``device``'s current stream
    (an int: what ``torch.cuda.current_stream(index).cuda_stream`` gives,
    without making a ``Stream`` object), with ``device`` the current device
    during the call: entered only where it is not already, since entering
    costs more host time than a short kernel takes."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        return launch(stream)
    with torch.cuda.device(index):
        return launch(stream)
