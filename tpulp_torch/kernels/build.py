"""Build and load the CUDA kernels of ``tpulp_torch.kernels``.

The sources in ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
process per source (two for the largest, one a type), all started
together, and linked into one shared
library with a plain C interface, at first use, into ``build/tpulp_torch/``
at the root of the checkout. The library is rebuilt when the hash of the
sources changes, and it is loaded with ``ctypes``. Nothing is built or
loaded when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["ARCH_FLAGS", "BUILD_DIR", "LIB_NAME", "SPLIT_BY_TYPE", "build",
           "load_library", "nvcc_commands", "source_files"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpulp_torch"
LIB_NAME = "libtpulp_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def source_files() -> list[Path]:
    """The CUDA sources and headers, in a fixed order."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in source_files():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "tpulp_torch CUDA kernels are built from source at first use")
    return found


# the sources with the most kernel instantiations, each compiled twice,
# its f32 and its f64 entry points apart (common.cuh's TPULP_TYPES), so
# that the halves compile side by side
SPLIT_BY_TYPE = ("bounded_grid.cu", "lanes.cu", "rank1_grid.cu")
TYPE_PARTS = (("f32", "-DTPULP_TYPES=1"), ("f64", "-DTPULP_TYPES=2"))


def nvcc_commands(out: Path, nvcc: str = "nvcc",
                  verbose: bool = False) -> tuple[list[list[str]], list[str]]:
    """The nvcc command lines that build the library ``out``: one compile
    per source, two for a source of ``SPLIT_BY_TYPE`` (all run in
    parallel), then the link."""
    compiles, objects = [], []
    for src in sorted(CSRC.glob("*.cu")):
        parts = TYPE_PARTS if src.name in SPLIT_BY_TYPE else ((None, None),)
        for part, define in parts:
            stem = src.stem if part is None else f"{src.stem}.{part}"
            obj = out.with_name(f"{out.name}.{stem}.o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                   "-fPIC", "-c"]
            if define is not None:
                cmd.append(define)
            if verbose:
                cmd.append("-Xptxas=-v")
            compiles.append(cmd + ["-o", str(obj), str(src)])
            objects.append(str(obj))
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *objects]
    return compiles, link


def _fail(cmd: list[str], code: int, out: str, err: str) -> RuntimeError:
    return RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}\n"
                        f"{err}")


def build(verbose: bool = False) -> Path:
    """Build the library unless one from the same sources exists; returns
    its path. ``verbose`` adds ``-Xptxas=-v`` and prints nvcc's report of
    registers and shared memory per kernel."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _source_hash()
    if (lib.exists() and stamp.exists() and not verbose
            and stamp.read_text().strip() == digest):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}.tmp"
    compiles, link = nvcc_commands(tmp, nvcc=_nvcc(), verbose=verbose)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in compiles]

    def finish(cmd, proc):
        out, err = proc.communicate()
        return cmd, proc.returncode, out, err, time.perf_counter() - t0

    # wait for every compile before looking at any result; each one's
    # seconds are taken when it ends
    with ThreadPoolExecutor(len(procs)) as pool:
        reports = list(pool.map(finish, compiles, procs))
    for cmd, code, out, err, _ in reports:
        if code != 0:
            raise _fail(cmd, code, out, err)
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise _fail(link, res.returncode, res.stdout, res.stderr)
    for cmd in compiles:
        os.remove(cmd[cmd.index("-o") + 1])
    if verbose:
        print(f"# nvcc {time.perf_counter() - t0:.1f} s ({len(compiles)} "
              f"compiles in parallel, then the link)")
        for cmd, _, out, err, secs in reports:
            define = next((c for c in cmd if c.startswith("-D")), "")
            print(f"# nvcc {secs:.1f} s: {Path(cmd[-1]).name} {define}")
            print(" ".join(cmd))
            print(out + err)
    os.replace(tmp, lib)
    stamp.write_text(digest + "\n")
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry point's
    argument types declared."""
    lib = ctypes.CDLL(str(build()))
    for name in ("tpulp_flush_f32", "tpulp_flush_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _P]
        fn.restype = _I
    for name in ("tpulp_flush_batch_f32", "tpulp_flush_batch_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _D, _D,
                       _P]
        fn.restype = _I
    for name in ("tpulp_inner_block_f32", "tpulp_inner_block_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 20 + [_I] * 12 + [_D] * 4 + [_P]
        fn.restype = _I
    for name in ("tpulp_fma_f32", "tpulp_fma_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _D, _L, _P, _P]
        fn.restype = _I
    for name in ("tpulp_shard_pivot_f32", "tpulp_shard_pivot_f64",
                 "tpulp_shard_vectors_f32", "tpulp_shard_vectors_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P]
        fn.restype = _I
    for name in ("tpulp_lane_dual_f32", "tpulp_lane_dual_f64",
                 "tpulp_lane_primal_f32", "tpulp_lane_primal_f64",
                 "tpulp_lane_bounded_f32", "tpulp_lane_bounded_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P]
        fn.restype = _I
    for name in ("tpulp_blocked_ray_f32", "tpulp_blocked_ray_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P]
        fn.restype = _I
    for name in ("tpulp_blocked_ray_batch_f32",
                 "tpulp_blocked_ray_batch_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _I, _P]
        fn.restype = _I
    for name in ("tpulp_rank1_cluster_f32", "tpulp_rank1_cluster_f64",
                 "tpulp_bounded_grid_f32", "tpulp_bounded_grid_f64",
                 "tpulp_rank1_grid_f32", "tpulp_rank1_grid_f64",
                 "tpulp_blocked_cluster_f32", "tpulp_blocked_cluster_f64",
                 "tpulp_blocked_cluster_batch_f32",
                 "tpulp_blocked_cluster_batch_f64",
                 "tpulp_blocked_grid_f32", "tpulp_blocked_grid_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P]
        fn.restype = _I
    for name in ("tpulp_rank1_cluster_occupancy_f32",
                 "tpulp_rank1_cluster_occupancy_f64",
                 "tpulp_bounded_grid_occupancy_f32",
                 "tpulp_bounded_grid_occupancy_f64",
                 "tpulp_rank1_grid_occupancy_f32",
                 "tpulp_rank1_grid_occupancy_f64",
                 "tpulp_blocked_cluster_occupancy_f32",
                 "tpulp_blocked_cluster_occupancy_f64",
                 "tpulp_blocked_grid_occupancy_f32",
                 "tpulp_blocked_grid_occupancy_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P]
        fn.restype = _I
    lib.tpulp_inner_block_slots.argtypes = []
    lib.tpulp_inner_block_slots.restype = _I
    lib.tpulp_inner_block_stages.argtypes = []
    lib.tpulp_inner_block_stages.restype = _I
    lib.tpulp_barrier_probe.argtypes = [_P, _I, _I, _I, _P]
    lib.tpulp_barrier_probe.restype = _I
    lib.tpulp_set_device.argtypes = [_I]
    lib.tpulp_set_device.restype = _I
    lib.tpulp_error_string.argtypes = [_I]
    lib.tpulp_error_string.restype = ctypes.c_char_p
    return lib
