"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers, ints and the
stream as ``void*``) and is compiled on first use, for Hopper only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \
         csrc/<name>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``),
with ptxas's report of each kernel's registers and spills beside it
(``<name>-<hash>.log``, read by :func:`ptxas_report`).
The sources share device code through ``csrc/*.cuh`` headers.  The file
name carries a hash of the source and of every header, so an edited source
or header is rebuilt and a stale library is never loaded.  Nothing here
runs at import time: the CPU tests import every module of the package on a
machine with no ``nvcc``.

Launch counts live here too: each kernel wrapper adds one to its entry in
:data:`LAUNCHES` where it launches its kernel, and nowhere else, so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel entry point -> launches since the last reset_launches()
LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (CUDA_HOME unset and no nvcc on PATH); "
            "the kernels are built with nvcc on first use"
        )
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are not
    built yet, one ``nvcc`` per source, all started together.  Returns the
    wall seconds each build took (0.0 for one already built)."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _compile_cmd(name, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


_FUNC = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Compiling entry function '(\S+)'|Used (\d+) registers")


def ptxas_report(name: str) -> dict[str, dict]:
    """ptxas's report for ``csrc/<name>.cu`` as built: {mangled kernel name:
    {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}.  Empty
    where the library was built without its log."""
    path = _target(name).with_suffix(".log")
    if not path.exists():
        return {}
    text = path.read_text()
    out: dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        m = _REGS.search(line)
        if m and m.group(1):
            current = out.setdefault(m.group(1), {})
        elif m and current is not None:
            current["registers"] = int(m.group(2))
        f = _FUNC.search(line)
        if f:
            current = out.setdefault(f.group(1), {})
        s = _SPILL.search(line)
        if s and current is not None:
            current["spill_stores"] = int(s.group(1))
            current["spill_loads"] = int(s.group(2))
    return out


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
