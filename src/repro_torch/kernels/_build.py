"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library's name carries a hash of
the sources and flags, so an edited source builds anew on its next use
and an unchanged one is loaded from ``kernels/build/``. Nothing is built
when the module is imported: ``load()`` builds on first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# extern "C" launchers: name -> argument kinds ("p" pointer, "i" int,
# "f" float). Every launcher returns cudaGetLastError() as an int;
# bgmv_slots and lora_grad_ab_slots return a count of blocks (negative: a
# CUDA error).
SIGNATURES: Dict[str, str] = {
    "bgmv_launch": "ppppp" + "iiiiiiiiii" + "p",
    "bgmv_slots": "iii",
    "paged_attn_launch": "ppppppp" + "iiiiii" + "ii" + "f" + "i" + "p",
    "flash_attn_launch": "ppppipp" + "iiiiiiii" + "iiii" + "f" + "i" + "p",
    "paged_verify_launch": "pppppppp" + "iiiiiii" + "ii" + "f" + "i" + "p",
    "lora_matmul_launch": "pppppppp" + "iiiiiiiiii" + "p",
    "lora_grad_ab_launch": "ppppppp" + "iiiiiiii" + "p",
    "lora_grad_ab_slots": "ii",
    "recon_agg_launch": "pppp" + "iiiii" + "p",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_loaded: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels-{source_hash()}.so"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be "
            "built on this machine")
    return found


def build() -> Path:
    """Compile and link the kernels if the library for the current sources
    is missing; return its path. Raises with the compiler's output on
    failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    # the build's one-shot time is a measurement kept in build_info, not a
    # recorded event, so it reads the clock itself
    t0 = time.perf_counter()  # repro: allow=clock-discipline (build time)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _obj, proc in jobs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [compiler, "-shared", *[str(o) for _, o, _ in jobs], "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    # repro: allow=clock-discipline (build time)
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(logs),
                      path=str(out))
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built from the sources on first use in this
    process and loaded once (later calls return it without re-hashing)."""
    lib = _loaded.get("lib")
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, kinds in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[k] for k in kinds]
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise when a launcher reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

def check_cuda_args(kernel: str, floats, ints=()) -> int:
    """Validate a launch's tensors: one CUDA device, contiguous, the float
    operands all float32 or all bfloat16, the index operands int32.
    Returns the kernel's dtype code."""
    tensors = list(floats) + list(ints)
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{kernel}: every operand must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    dtype = floats[0].dtype
    if dtype not in DTYPE_CODES or any(t.dtype != dtype for t in floats):
        raise TypeError(f"{kernel}: float operands must all be float32 or "
                        f"all bfloat16, got {[t.dtype for t in floats]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{kernel}: index operands must be int32, got "
                        f"{[t.dtype for t in ints]}")
    return DTYPE_CODES[dtype]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``: the split plans aim at one block
    each."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
