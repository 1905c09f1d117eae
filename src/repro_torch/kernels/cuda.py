"""Build and bind the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded with
`ctypes`. No source includes PyTorch's headers, so a build takes seconds.
`build` starts one ``nvcc`` per source, all at once, and waits for all of
them; a library's file name carries a hash of its sources and flags, so a
stale build is never loaded.

Libraries go to ``build/repro_torch_kernels/`` at the root of the checkout
(``.gitignore`` lists ``build/``). Nothing is built at import: the first
launch of a kernel builds every source that is not built yet.

A `CudaKernel` is one C entry point. Every entry point takes its pointers
and sizes, then the CUDA stream, and returns ``cudaGetLastError()`` after
its launch; `CudaKernel.__call__` passes PyTorch's current stream and
raises if the code is not 0. ``launches`` counts the launches of that
kernel and is changed nowhere else.

Kernels may be launched from more than one thread (the query server's
scheduler thread and the caller's): `load` and the binding of an entry
point hold one lock, so a first launch from two threads at once builds and
loads a library once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("bitset", "stwig_expand", "hash_join", "cin", "segment_mp", "join_probe",
           "flash_attention", "flash_attention_tc", "flash_attention_tf32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# sources this process compiled (nvcc runs it started): a rank of a mesh
# only loads the libraries its parent built, and reports this as 0
sources_built = 0
_LOAD_LOCK = threading.Lock()  # held while a library is built, loaded or bound


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    in parallel. Returns the compiler's messages per source built (with
    ``ptxas_verbose``, each kernel's registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas=-v"] if ptxas_verbose else [])
    running = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    global sources_built
    sources_built += len(running)
    messages = {}
    failed = []
    for name, (proc, tmp, out) in running.items():
        messages[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{messages[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return messages


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed.
    Thread-safe: a second caller waits for the first one's build."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = _lib_path(name)
                if not path.exists():
                    build()
                lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


class CudaKernel:
    """One C entry point of one CUDA source, bound on first call."""

    registry: list["CudaKernel"] = []

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._fn = None
        CudaKernel.registry.append(self)

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._bind()
        # PyTorch's current stream, read anew at each call, so that a launch
        # lands on the stream of torch.cuda.stream(s) or of a graph capture.
        # The raw accessor gives torch.cuda.current_stream().cuda_stream
        # without building a Stream object, the largest piece of a small
        # kernel's host path.
        stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed to launch: error {err}"
            )
        self.launches += 1

    def _bind(self) -> None:
        lib = load(self.source)
        with _LOAD_LOCK:
            if self._fn is None:
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn


def launch_counts() -> dict[str, int]:
    """Launches of every kernel so far, by C entry point name."""
    return {k.symbol: k.launches for k in CudaKernel.registry}


def reset_launch_counts() -> None:
    for k in CudaKernel.registry:
        k.launches = 0


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim`` — what the kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: a raw launcher
    writes a fresh output through a pointer, so its output would carry no
    graph and every upstream gradient would be lost without a word. The
    autograd Function beside each launcher is the differentiable entry."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the raw launcher has no backward; "
            f"call its autograd Function (or Kernels.{name}) instead"
        )


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrappers then run the
    plain version); False when all lie on one CUDA device. Raises on a mix.
    The common cases read two flags a tensor and build no device object."""
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        for t in tensors:
            if not t.is_cuda or t.get_device() != index:
                break
        else:
            return False
    elif first.is_cpu:
        for t in tensors:
            if not t.is_cpu:
                break
        else:
            return True
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    raise ValueError(f"no kernel for device {devices.pop()}")
