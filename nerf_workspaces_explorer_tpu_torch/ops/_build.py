"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library exposes a plain C entry point and compiles on its own into
`build/torch_kernels/<name>-<source hash>.so` under the repository root (a
gitignored directory), at first use, with nvcc's output (the `-Xptxas -v`
report: registers, shared memory, spills) beside it in
`<name>-<source hash>.log`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v [extra flags] -o <lib> csrc/<source>.cu

A library is `csrc/<name>.cu` itself, or one of VARIANTS: a source compiled
with extra flags (the render kernel and the training field, once per
network shape). The hash of
the source, the shared headers (`csrc/*.cuh`) and the flags in the file name
means an edited source never loads a stale library.

`ENTRY_TYPES` holds the C calling convention of every entry point, in the
order of its `extern "C"` declaration: pointers (and the stream) cross as
`c_void_p`, `int` as `c_int`, `long long` as `c_longlong`, `float` as
`c_float`. Every entry point returns an int, a CUDA error code (0 for
none). `entry` binds an entry of a loaded library to its types once;
`launch` calls it and raises on a nonzero code. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Any, Dict, Iterable, Tuple

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The network shapes (width, point frequencies) the render kernel (K1/K3/K7)
# is built for, those of the in-repo checkpoints -> whether the full pass is
# built too (the 2x64 proposal net runs density-only).
RENDER_SHAPES = {(64, 6): False, (128, 8): True, (192, 10): True, (256, 10): True}

# The shapes the fine-pass ablation (K8, the render kernel's int8 full pass
# with an ablation mask) is built for: the 4x128@8f student the ablation
# script profiles.
ABLATION_SHAPES = ((128, 8),)

# The network shapes (width, point frequencies, view frequencies) the
# training field (K4/K5) is built for: the stock 8x256 net, the 2x64
# proposal net, and the two distilled students (train/distill.py): the
# default 6x192@10f and the opt-in 4x128@8f.
FIELD_SHAPES = ((256, 10, 4), (64, 6, 2), (192, 10, 4), (128, 8, 4))

def field_library(width: int, pts_freqs: int, view_freqs: int) -> str:
    """The name of the training field's library for one network shape."""
    return f"train_field_w{width}f{pts_freqs}v{view_freqs}"


# Libraries built from a shared source with extra flags: name -> (source
# stem in csrc/, flags). The render kernel and the training field compile
# once per shape, and the render kernel's ablation into libraries of their
# own, so the served ones never hold it.
VARIANTS = {
    f"fused_render_w{w}f{f}": (
        "fused_render",
        (f"-DRENDER_WIDTH={w}", f"-DRENDER_FREQS={f}", f"-DRENDER_FULL={int(full)}"),
    )
    for (w, f), full in RENDER_SHAPES.items()
}
VARIANTS.update({
    f"fused_render_ablate_w{w}f{f}": (
        "fused_render", (f"-DRENDER_WIDTH={w}", f"-DRENDER_FREQS={f}", "-DRENDER_ABLATE=1"),
    )
    for w, f in ABLATION_SHAPES
})
VARIANTS.update({
    field_library(w, f, v): (
        "train_field", (f"-DFIELD_WIDTH={w}", f"-DFIELD_PTS_FREQS={f}", f"-DFIELD_VIEW_FREQS={v}"),
    )
    for w, f, v in FIELD_SHAPES
})

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# Every C entry point of csrc/*.cu -> its argument types.
ENTRY_TYPES = {
    # csrc/fused_render.cu (K1/K3/K7)
    "nerf_render_launch": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _F, _I, _P, _P),
    # csrc/fused_render.cu built with -DRENDER_ABLATE=1 (K8)
    "nerf_ablation_launch": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P),
    # csrc/importance_merge.cu (K2/K6, and the empty kernel of the launch floor)
    "importance_merge_launch": (_P, _P, _P, _I, _I, _I, _I, _P),
    "importance_empty_launch": (_P,),
    # csrc/int4_probe.cu (K9)
    "int4_probe_launch": (_P, _P, _P, _I, _I, _I, _I, _P),
    # csrc/train_field.cu (K4/K5)
    "field_forward_launch": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P),
    "field_backward_launch": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "field_backward_sizes": (_I, _I, _L, _P, _P, _P),
    # csrc/mipnerf360.cu (K10-K13)
    "m360_encode_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "m360_linear_launch": (_I, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    "m360_place_launch": (_P, _P, _I, _F, _P, _P, _I, _I, _F, _F, _P),
    "m360_composite_launch": (_P, _P, _I, _F, _P, _P, _P, _P, _I, _I, _P),
}

# A shared library, once loaded, is process-wide; so are these caches of
# the libraries and of their bound entry points.
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[ctypes.CDLL, str], Any] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def _source_and_flags(name: str):
    source, extra = VARIANTS.get(name, (name, ()))
    return os.path.join(CSRC_DIR, f"{source}.cu"), (*NVCC_FLAGS, *extra)


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers and
    the flags."""
    source, flags = _source_and_flags(name)
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [source, *(os.path.join(CSRC_DIR, h) for h in headers)]:
        with open(source, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def _log_path(lib: str) -> str:
    return lib[: -len(".so")] + ".log"


def build_log(name: str) -> str:
    """nvcc's output for the current library `name`."""
    with open(_log_path(library_path(name))) as f:
        return f.read()


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that have no current library, all nvcc
    processes started together. Returns {name: library path}."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if os.path.exists(lib) and os.path.exists(_log_path(lib)):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        source, flags = _source_and_flags(name)
        cmd = [nvcc_path(), *flags, "-o", tmp, source]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", _log_path(lib))
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(build([name])[name])
        return lib


def entry(lib: ctypes.CDLL, symbol: str):
    """The C function `symbol` of the loaded library `lib`, bound to its
    `ENTRY_TYPES` once."""
    with _LOCK:
        fn = _ENTRIES.get((lib, symbol))
        if fn is None:
            fn = _ENTRIES[(lib, symbol)] = getattr(lib, symbol)
            fn.argtypes, fn.restype = ENTRY_TYPES[symbol], ctypes.c_int
        return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def launch(name: str, symbol: str, *args) -> None:
    """Call the entry point `symbol` of the library `name` (built and
    loaded first if needed) and raise on a nonzero code."""
    check(entry(load(name), symbol)(*args), symbol)


def slab_arrays(table) -> Tuple[ctypes.Array, ctypes.Array]:
    """A weight stream's table of (name, byte offset, bytes, ...) slabs as
    the launch entries' host arrays: (offsets, bytes), C ints."""
    return tuple((ctypes.c_int * len(table))(*[e[i] for e in table]) for i in (1, 2))


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
