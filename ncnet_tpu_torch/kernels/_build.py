"""Build and load of the hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain ``extern "C"`` launcher
(no PyTorch headers, so ``nvcc`` takes seconds); the ``csrc/*.cuh``
headers are shared. `build` compiles it on first use into
``_build/<name>-<sha256 prefix>/lib<name>.so``, keyed on the bytes of the
source and the headers and on the flags, and `KernelLibrary` loads it with
``ctypes`` once per process. `tensor_core_counts` reads what was compiled:
the ``HMMA``/``HGMMA`` (tensor-core) instructions of each kernel function,
from ``cuobjdump -sass``.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


#: SASS opcodes of the tensor cores: mma.sync (HMMA) and wgmma (HGMMA)
_TENSOR_CORE_OP = re.compile(r"\b(HMMA|HGMMA)\b")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")


def find_nvcc(label, source):
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        f"nvcc not found (set CUDA_HOME): the {label} kernel is built from "
        f"{source} on first use"
    )


def source_digest(source, csrc=CSRC):
    """sha256 of ``source``, every ``*.cuh`` header of ``csrc`` (which the
    sources include) and the flags: the key of a build."""
    with open(source, "rb") as f:
        src = f.read()
    for header in sorted(os.listdir(csrc)):
        if header.endswith(".cuh"):
            with open(os.path.join(csrc, header), "rb") as f:
                src += f.read()
    return hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()


def build(source, label):
    """Compile ``source`` into a shared library unless one built from the
    same bytes and flags exists; returns ``(path, ptxas_log)``.

    The library lives in ``BUILD_DIR/<name>-<sha256 prefix>/`` so a changed
    source never loads a stale build. The compiler writes to a temporary
    name that is renamed into place, so a build that is cut off leaves no
    library behind.
    """
    digest = source_digest(source)
    name = os.path.splitext(os.path.basename(source))[0]
    out_dir = os.path.join(BUILD_DIR, f"{name}-{digest[:16]}")
    lib = os.path.join(out_dir, f"lib{name}.so")
    log = os.path.join(out_dir, "ptxas.log")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [find_nvcc(label, source), *NVCC_FLAGS, "-o", tmp, source],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (rc {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    with open(log) as f:
        return lib, f.read()


def sass_tensor_core_counts(sass):
    """``{kernel function: number of HMMA/HGMMA instructions}`` in the text
    of ``cuobjdump -sass``; every function of the text is a key."""
    counts, fn = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            fn = m.group(1)
            counts.setdefault(fn, 0)
        elif fn is not None and _TENSOR_CORE_OP.search(line):
            counts[fn] += 1
    return counts


#: the names every kernel function of a tensor-core route carries: the
#: bfloat16 routes and the float32 split-TF32 route
BF16_ROUTE = "bf16_tc"
TF32X3_ROUTE = "tf32x3"


def tensor_core_summary(counts):
    """What `sass_tensor_core_counts` says of the tensor-core routes: for
    the bfloat16 and the split-TF32 functions, how many there are, their
    HMMA/HGMMA count in all and the least of any one function; and the
    count of every other function (the CUDA-core routes, which hold
    none)."""
    bf16 = [n for fn, n in counts.items() if BF16_ROUTE in fn]
    tf32 = [n for fn, n in counts.items() if TF32X3_ROUTE in fn]
    return {
        "bf16_route_functions": len(bf16),
        "bf16_route_mma": sum(bf16),
        "bf16_route_min_mma": min(bf16, default=0),
        "tf32x3_route_functions": len(tf32),
        "tf32x3_route_mma": sum(tf32),
        "tf32x3_route_min_mma": min(tf32, default=0),
        "other_mma": sum(n for fn, n in counts.items()
                         if BF16_ROUTE not in fn and TF32X3_ROUTE not in fn),
    }


def find_cuobjdump():
    """``cuobjdump`` beside ``nvcc``, or None where the toolkit has none."""
    try:
        nvcc = find_nvcc("cuobjdump", "the toolkit")
    except RuntimeError:
        return None
    path = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return path if os.path.exists(path) else shutil.which("cuobjdump")


class KernelLibrary:
    """One kernel's shared library, built and loaded on first use.

    ``symbol`` is the ``extern "C"`` launcher, which returns an int status;
    ``argtypes`` its ctypes argument types. The library must also export
    ``<symbol>_error_string(int) -> const char*``.
    """

    def __init__(self, source, label, symbol, argtypes):
        self.source = source
        self.label = label
        self._symbol = symbol
        self._argtypes = argtypes
        self._fn = None
        self._error_string = None
        self.path = None
        self._lock = threading.Lock()

    def load(self):
        """Build (first use) and load the library; returns the ptxas log."""
        with self._lock:
            path, log = build(self.source, self.label)
            self.path = path
            if self._fn is None:
                lib = ctypes.CDLL(path)
                fn = getattr(lib, self._symbol)
                fn.argtypes = list(self._argtypes)
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self._symbol}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._error_string = err
                self._fn = fn
        return log

    def launch(self, *args):
        """Call the launcher; returns ``(code, message)`` (0, '') on
        success."""
        if self._fn is None:
            self.load()
        code = self._fn(*args)
        return code, ("" if code == 0 else self._error_string(code).decode())

    def tensor_core_counts(self):
        """Build (first use) and disassemble the library: ``{kernel
        function: HMMA/HGMMA count}``, or None where ``cuobjdump`` is
        absent."""
        self.load()
        tool = find_cuobjdump()
        if tool is None:
            return None
        proc = subprocess.run([tool, "-sass", self.path], capture_output=True,
                              text=True, check=True)
        return sass_tensor_core_counts(proc.stdout)
