"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  All sources build at
once, one ``nvcc`` process each, on the first kernel launch of a
process -- or explicitly through :func:`build_all`.  Libraries go under
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time.  Loading
and the launch counts are thread-safe: ranks run as threads
(``core.dist_comm.ThreadComm``) may launch their first kernel at once.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["SOURCES", "NVCC_FLAGS", "build_dir", "build_all", "build_log",
           "ptxas_usage", "load", "check", "count_launch"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("pjds_spmv", "sell_spmv", "fused_iter", "ellr_spmv",
           "cmrs_spmv", "pjds_spmm", "krylov_step", "transpose_spmv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}          # name -> ctypes.CDLL, per process
_BUILD_LOG: dict = {}     # name -> nvcc stderr of this process's build
_LOAD_LOCK = threading.Lock()    # one build and load per process
_COUNT_LOCK = threading.Lock()   # launch counts


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the repro_torch kernels are "
                           "built from source on the machine with the card")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    """``<repo>/build/repro_torch_kernels/<source hash>``."""
    root = pathlib.Path(__file__).resolve().parents[3]
    return root / "build" / "repro_torch_kernels" / _digest()


def build_all() -> dict:
    """Compile every source that has no library yet, all in parallel.
    Returns ``{name: seconds}`` for what was compiled ({} when nothing
    was); raises with nvcc's output if any compile fails."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return {}
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    times, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        _BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---"
                          f"\n{log}")
            os.unlink(tmp)
            continue
        # atomic publish: a concurrent process sees the old state or
        # the finished library, never a half-written one
        os.replace(tmp, out / f"lib{name}.so")
        (out / f"{name}.log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for ``name``, from this process's build or the cached build."""
    if name in _BUILD_LOG:
        return _BUILD_LOG[name]
    f = build_dir() / f"{name}.log"
    return f.read_text() if f.exists() else ""


def ptxas_usage(log: str) -> dict:
    """``{kernel: {"registers": per thread, "spill_stores": bytes}}``
    from an nvcc build log (``-Xptxas -v``), one entry per compiled
    kernel (every template instance), names demangled by the toolkit's
    ``cu++filt``."""
    out, entry, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            entry, spill = ln.split("'")[1], 0
        elif "bytes spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif entry is not None and "Used " in ln and " registers" in ln:
            out[entry] = {"registers": int(ln.split("Used ")[1].split()[0]),
                          "spill_stores": spill}
            entry = None
    if not out:
        return out
    names = subprocess.run(
        [str(pathlib.Path(_nvcc()).with_name("cu++filt")), *out],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.splitlines()
    return dict(zip(names, out.values()))


def load(name: str):
    """The ctypes library of kernel source ``name``, building all
    sources first if needed.  Threads that ask at once wait for one
    build."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                import ctypes
                build_all()
                lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
                err = getattr(lib, f"{name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                _LIBS[name] = lib
    return lib


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.launches`` (a kernel wrapper's count of the
    launches it made; or to another count ``attr`` of it), atomically
    across threads."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def check(name: str, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({msg.decode() if msg else 'unknown'})")
