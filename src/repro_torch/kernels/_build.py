"""Build the CUDA sources in ``repro_torch/csrc`` at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The first :func:`library` call builds every source whose library is missing,
all ``nvcc`` processes at once, into ``csrc/build/`` (listed in
``.gitignore``).  A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source never loads a stale build.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.  The launch is on the
caller's stream and never synchronises.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Shared memory one block may use on Hopper (227 KB of the SM's 256 KB);
# csrc/common.cuh holds the same number for the C side.  An SM's blocks
# together may use 228 KB, less 1 KB the hardware reserves for each block.
MAX_SHARED_BYTES = 232448
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
SM_MAX_THREADS = 2048
SM_MAX_BLOCKS = 32

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under PyTorch's
    ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _compile(nvcc: str, src: pathlib.Path, out: pathlib.Path) -> str:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source name: nvcc output}`` for what was built (``-Xptxas=-v``
    makes that output list each kernel's registers and shared memory).
    """
    todo = [(src, library_path(src)) for src in sorted(CSRC.glob("*.cu"))]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        futures = {src.name: pool.submit(_compile, nvcc, src, out) for src, out in todo}
        errors, logs = [], {}
        for name, fut in futures.items():
            try:
                logs[name] = fut.result()
            except RuntimeError as exc:
                errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str, signatures: dict[str, tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if missing), with
    ``argtypes``/``restype`` set from ``signatures``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(CSRC / f"{name}.cu")))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA error {code} ({lib.error_string(code).decode()})"
        )


def refuse_grad(what: str, *inputs: torch.Tensor) -> None:
    """Raise if autograd would record through a kernel launch: grad mode on
    and an input that requires grad.  A kernel called through ``ctypes``
    returns a tensor with no ``grad_fn``, so it would cut the graph without
    a word.  The kernels have no backward: the LM trainer runs the plain
    paths, as the reference's training forward reaches no Pallas kernel
    (ROADMAP Queue 1 item 18).  Their plain versions, which CPU tensors
    run, stay differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, so it cannot run on an input "
            "that requires grad with grad mode on (the graph would be cut). Run it "
            "under torch.no_grad() or torch.inference_mode(); training runs the plain "
            "paths (attn_impl='xla', latent weights), ROADMAP Queue 1 item 18"
        )


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
