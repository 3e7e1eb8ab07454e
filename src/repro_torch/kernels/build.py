"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

At first use :func:`library` compiles each of ``kernels/csrc/*.cu`` for
``sm_90a`` into an object file, one ``nvcc`` process per source, all
started together, and links them into one shared library with a plain C
interface, under ``build/repro_torch/`` at the root of the checkout, named
by a hash of the sources, headers and flags so that an edited source
builds anew.  Nothing is compiled when a module is imported.

``nvcc`` is found through ``CUDA_HOME``, ``PATH`` or
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

__all__ = ["BUILD_DIR", "SOURCES", "find_nvcc", "library"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "fused_aggregate.cu", _CSRC / "fused_memory.cu",
           _CSRC / "relay_block.cu", _CSRC / "flash_attention.cu", _CSRC / "ssd_scan.cu")
_HEADERS = (_CSRC / "common.cuh",)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # (A, tau_up, tau_dd, x, out, n, d, block_d, dtype, inv_n, stream)
    "repro_fused_aggregate": (_P, _P, _P, _P, _P, _I, _I64, _I64, _I, _F, _P),
    # (w, table of (x, d) rows, segments, out, n, block_d, dtype, stream)
    "repro_row_stream": (_P, ctypes.POINTER(_I64), _I, _P, _I, _I64, _I, _P),
    # (A, tau_up, tau_dd, scale, q, out, n, d, block_d, inv_n, stream)
    "repro_fused_dequant_aggregate": (_P, _P, _P, _P, _P, _P, _I, _I64, _I64, _F, _P),
    # (A, tau_up, tau_dd, x, ldx, buf, ldb, delta, n, d, block_d, dtype, inv_n, stream)
    "repro_fused_memory_update": (_P, _P, _P, _P, _I64, _P, _I64, _P, _I, _I64, _I64, _I,
                                  _F, _P),
    # (mix, tau_up, table of (x, ldx, d) rows, segments, buf, ldb, delta, n, block_d,
    # dtype, inv_n, stream)
    "repro_memory_stream": (_P, _P, ctypes.POINTER(_I64), _I, _P, _I64, _P, _I, _I64, _I, _F,
                            _P),
    # (A, tau_up, tau_b, x, w scratch, out, C, m, d, block_d, dtype, inv_n, stream)
    "repro_block_fused_aggregate": (_P, _P, _P, _P, _P, _P, _I, _I, _I64, _I64, _I, _F, _P),
    # (w, x, out, n, d, block_d, dtype, stream)
    "repro_block_row_stream": (_P, _P, _P, _I, _I64, _I64, _I, _P),
    # (A, tau_b, x, out, C, m, d, dtype, stream)
    "repro_block_relay_mix": (_P, _P, _P, _P, _I, _I, _I64, _I, _P),
    # (mix, x, out, n, d, dtype, stream)
    "repro_relay_mix": (_P, _P, _P, _I, _I64, _I, _P),
    # (q, k, v, out, strides[12], B, H, KV, T, D, dtype, stream)
    "repro_flash_attention": (_P, _P, _P, _P, ctypes.POINTER(_I64), _I, _I, _I, _I, _I, _I, _P),
    # (D) -> dynamic shared memory bytes of the bf16 kernel
    "repro_flash_tc_smem_bytes": (_I,),
    # (q, k, v, log_decay, out, strides[15], BH, H, T, Dk, Dv, chunk, dtype, stream)
    "repro_ssd_scan": (_P, _P, _P, _P, _P, ctypes.POINTER(_I64), _I, _I, _I, _I, _I, _I, _I,
                       _P),
    # occupancy, blocks an SM: (chunk, Dk, Dv) of the bf16 SSD kernel; (m, dtype,
    # vector path) of the relay mix
    "repro_ssd_scan_blocks_per_sm": (_I, _I, _I),
    "repro_relay_mix_blocks_per_sm": (_I, _I, _I),
}


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(pathlib.Path(on_path))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of repro_torch are compiled at first use and need the "
        "CUDA toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES + _HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands side by side, wait for every one of them, and
    raise with the compiler's report if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return "".join(out + err for out, err in outs)


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernels, built on first call (and cached on disk and
    in the process); the compiler's report is kept beside the library."""
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, tag = find_nvcc(), f"{lib_path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
        log = _run_all([[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(SOURCES, objs)])
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp, lib_path)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib
