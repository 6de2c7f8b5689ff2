"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for Hopper (sm_90a) into its own shared
library with a plain C interface, loaded with ctypes. No PyTorch header is
included, so a build takes seconds; a source with many kernels (PARTS)
compiles as several translation units at once, linked after. Libraries
land in build/torch_kernels/ at the repository root, named by a hash of
their source, so a changed source rebuilds and an unchanged one loads at
once. Nothing is built when a module is imported: the first launch (or
build_all) builds. The host moves the build to the directory
`tpu.compile_cache` names (utils/compile_cache.py) before its first build.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

or, for a source in PARTS, `-c -DSYMTORCH_PART=<p> -o <p>.o` in place of
`-shared -o <lib>.so` for each part p, then `nvcc -gencode ... -shared -o
<lib>.so *.o`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                     / "torch_kernels")
BUILD_DIR = DEFAULT_BUILD_DIR

# Library name -> (source file, {C entry point: argtypes}).
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SOURCES: dict[str, tuple[str, dict[str, list]]] = {
    "flash_prefill": ("flash_prefill.cu", {
        # dtype, q, k, v, seq_lens, out, B, S, H, K, D,
        # q/k/v/out strides (batch, seq, head), window, stream
        "flash_prefill_launch": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                                 _LL, _LL, _LL, _I, _P],
        # the tensor-core variant (bf16): the same without the dtype
        "flash_prefill_tc_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                                    _LL, _LL, _LL, _LL, _I, _P],
    }),
    "decode_attention": ("decode_attention.cu", {
        # dtype, kv_dtype, q, k_cache, v_cache, k_scale, v_scale, kv_length,
        # k_new, v_new, positions (append mode, else null), out, scratch,
        # L, B, T, K, D, n_q, layer, window, span, n_spans, stream
        "decode_attention_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _P],
    }),
    "kv_append": ("kv_append.cu", {
        # dtype, k_new, v_new, k_cache, v_cache, k_scale, v_scale,
        # positions, L, B, T, K, D, layer, stream
        "kv_append_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P],
    }),
    "w8a16": ("w8a16.cu", {
        # regime, x_dtype, out_dtype, x, w, scale, out, M, K, N, splits,
        # k_per_split, clusters, apply_scale, tile_rows, stream
        "w8a16_launch": [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P],
        # x_dtype, cluster, int* fit
        "w8a16_gemv_capacity": [_I, _I, _P],
    }),
    "w8a8": ("w8a8.cu", {
        # out_dtype, xq, w, xs, ws, out, part, M, K, N, splits,
        # k_per_split, tile_rows, stream
        "w8a8_launch": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    }),
    "moe_gemv": ("moe_gemv.cu", {
        # x_dtype, out_dtype, x, w, scale, out, X, x_shared, M, K, N, np,
        # cols, splits, k_per_split, clusters, apply_scale, stream
        "moe_gemv_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P],
        # x_dtype, np, cluster, int* fit
        "moe_gemv_capacity": [_I, _I, _I, _P],
    }),
}

# Sources built as several translation units, compiled at once and linked
# into one library: name -> units (csrc/decode_attention.cu SYMTORCH_PART).
PARTS = {"decode_attention": 11}

# Kernel dtype codes shared with csrc/.
DTYPE_F32, DTYPE_BF16, DTYPE_INT8 = 0, 1, 2

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# Library name -> seconds its nvcc took in this process's last build of it.
BUILD_SECONDS: dict[str, float] = {}


class KernelError(RuntimeError):
    """A kernel failed to build or a launch returned a CUDA error."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                          "are built from source at first use")
    return found


def set_build_dir(path: str | os.PathLike) -> None:
    """Build into and load from `path` from now on (libraries already
    loaded stay loaded)."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path)


def lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [CSRC / SOURCES[name][0], *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    digest = digest.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _units(name: str) -> list[list[str]]:
    """nvcc's extra arguments for each translation unit of library `name`:
    one unit, or one per SYMTORCH_PART value for a source built in
    PARTS parts."""
    if name not in PARTS:
        return [[]]
    return [[f"-DSYMTORCH_PART={p}"] for p in range(PARTS[name])]


def build_all(names: list[str] | None = None) -> float:
    """Compile every library not yet built, one nvcc per translation unit,
    all started together (a source in PARTS compiles to objects, linked
    into its library after). Returns the wall seconds spent; raises
    KernelError with the compiler's output if any build fails. nvcc's
    -Xptxas -v report (registers, shared memory, spills) is kept beside
    each library as <lib>.log, and each library's own seconds (its slowest
    unit and its link) in BUILD_SECONDS."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [(n, lib_path(n)) for n in (names or list(SOURCES))
                if not lib_path(n).exists()]
        arch = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a"]

        def run(cmd: list[str]) -> tuple:
            t = time.perf_counter()
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            return proc, time.perf_counter() - t

        jobs = []  # (library, output, extra arguments)
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            units = _units(name)
            for i, extra in enumerate(units):
                obj = (tmp if len(units) == 1
                       else tmp.with_suffix(f".{i}.o"))
                jobs.append((name, obj, extra + (
                    ["-shared"] if len(units) == 1 else ["-c"])))
        with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
            done = list(pool.map(lambda job: run(
                arch + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", *job[2], "-o", str(job[1]),
                        str(CSRC / SOURCES[job[0]][0])]), jobs))
        failed = []
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            mine = [(job, res) for job, res in zip(jobs, done)
                    if job[0] == name]
            log = "".join(proc.stdout for _, (proc, _) in mine)
            seconds = max(sec for _, (_, sec) in mine)
            ok = all(proc.returncode == 0 for _, (proc, _) in mine)
            if ok and len(mine) > 1:
                proc, sec = run(arch + ["-shared", "-o", str(tmp)] + [
                    str(job[1]) for job, _ in mine])
                log += proc.stdout
                seconds += sec
                ok = proc.returncode == 0
            if len(mine) > 1:
                for job, _ in mine:
                    job[1].unlink(missing_ok=True)
            BUILD_SECONDS[name] = seconds
            out.with_suffix(".log").write_text(
                f"{log}\nnvcc seconds: {seconds:.1f}\n")
            if not ok:
                failed.append(f"{name}:\n{log[-4000:]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise KernelError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in SOURCES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry point."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc}")


def dtype_code(dtype: torch.dtype) -> int:
    codes = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16}
    if dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    return codes[dtype]
