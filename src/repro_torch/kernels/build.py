"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/repro_torch/`` at
the root of the checkout, at first use; the library is loaded with
``ctypes``.  A library may hold several kernels (``paged_kv.cu`` holds the
gather and the scatter; ``ptc_wide.cu`` the k > 32 routes of the three
PTC kernels; ``ptc_wide_tc.cu`` the bf16 tensor-core routes of the three;
``ptc_wide_3xtf32.cu`` the fp32 3xTF32 routes of all three),
and one TPU kernel may have several routes
(``prefill_attention`` on the tensor cores, ``prefill_attention_cudacore``
for the pairs they do not take; ``mesh_apply``, and past k = 32
``mesh_apply_wide_unrolled`` at k = 64 and 128 and ``mesh_apply_wide``
at other k; ``ptc_block_matmul_wide``, ``ptc_block_matmul_wide_tc``
for bf16 and ``ptc_block_matmul_wide_3xtf32`` for fp32 at k = 64 and
128): :data:`KERNELS` names each kernel's library.  Library
names carry a hash of the source and the flags, so an edited source is
never served a stale build.  :func:`build` starts one
``nvcc`` per source, all at once.

Nothing here runs at import time: a CUDA-less host imports the package and
uses the plain PyTorch versions.

The launch counters live here too: each kernel wrapper adds one to its
entry in :data:`launch_counts` where it launches its kernel, and nowhere
else (:func:`count_launch`), so a run can show that its path went through
the kernels.  A thread that captures a CUDA graph counts into its own
tally instead (:func:`tally_launches`), which each replay adds.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "KERNELS", "BUILD_DIR", "NVCC_FLAGS", "build",
           "library", "check_status", "launch_counts", "reset_launch_counts",
           "count_launch", "add_launches", "tally_launches", "sm_count"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# library name -> source file
SOURCES = {"mesh_apply": "mesh_apply.cu",
           "ptc_block_matmul": "ptc_block_matmul.cu",
           "sigma_grad": "sigma_grad.cu",
           "ptc_wide": "ptc_wide.cu",
           "ptc_wide_tc": "ptc_wide_tc.cu",
           "ptc_wide_3xtf32": "ptc_wide_3xtf32.cu",
           "feedback_matmul": "feedback_matmul.cu",
           "paged_kv": "paged_kv.cu",
           "prefill_attn": "prefill_attn.cu",
           "prefill_attn_tc": "prefill_attn_tc.cu"}
# kernel name (the launch counter's key) -> library name
KERNELS = {"mesh_apply": "mesh_apply",
           "mesh_apply_wide": "mesh_apply",
           "mesh_apply_wide_unrolled": "mesh_apply",
           "ptc_block_matmul": "ptc_block_matmul",
           "ptc_block_matmul_perblock": "ptc_block_matmul",
           "ptc_block_matmul_wide": "ptc_wide",
           "ptc_block_matmul_wide_tc": "ptc_wide_tc",
           "ptc_block_matmul_wide_3xtf32": "ptc_wide_3xtf32",
           "sigma_grad": "sigma_grad",
           "sigma_grad_wide": "ptc_wide",
           "sigma_grad_wide_tc": "ptc_wide_tc",
           "sigma_grad_wide_3xtf32": "ptc_wide_3xtf32",
           "feedback_matmul": "feedback_matmul",
           "feedback_matmul_wide": "ptc_wide",
           "feedback_matmul_wide_tc": "ptc_wide_tc",
           "feedback_matmul_wide_3xtf32": "ptc_wide_3xtf32",
           "paged_gather": "paged_kv",
           "paged_scatter": "paged_kv",
           "prefill_attention": "prefill_attn_tc",
           "prefill_attention_cudacore": "prefill_attn"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launch_counts: dict[str, int] = {name: 0 for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
_sms: dict[int, int] = {}


_count_lock = threading.Lock()
_tally = threading.local()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name``: into :data:`launch_counts`, or into
    the tally of a capture this thread has open."""
    tally = getattr(_tally, "counts", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _count_lock:
        launch_counts[name] += 1


def add_launches(counts: dict[str, int]) -> None:
    """Add a replayed graph's launches (a tally) to :data:`launch_counts`."""
    with _count_lock:
        for name, n in counts.items():
            launch_counts[name] += n


@contextlib.contextmanager
def tally_launches():
    """Within the block this thread's launches go to the yielded dict, not
    to :data:`launch_counts`: a CUDA graph's capture launches nothing, and
    its replays add the tally.  Other threads count as before."""
    counts: dict[str, int] = {}
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None, force: bool = False) -> dict:
    """Compile the named libraries (default: all) in parallel.

    Returns the wall seconds of the whole build and the names it built.  ``ptxas`` reports
    (registers, shared memory, spills) are kept beside each library as
    ``<name>.ptxas.log``.  Raises with nvcc's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(dict.fromkeys(names))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.ptxas.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": sorted(procs)}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name`` (a key of :data:`SOURCES`),
    built if missing."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (the kernels' plans size their
    grids by it)."""
    import torch
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def check_status(name: str, status: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if status != 0:
        msg = library(name).repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} at launch: {msg}")
