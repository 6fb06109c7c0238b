"""lib_lightgbm_torch.so: the port's C API library, built at first use.

The source is c_api_shim.cpp beside this file, the JAX package's shim
pointed at lightgbm_tpu_torch.capi_bridge. `build_library()` compiles
it with g++ against the running interpreter's headers into
lightgbm_tpu_torch/csrc/build/capi_<hash>/lib_lightgbm_torch.so (the
hash covers the source, the flags and the interpreter), linked to the
interpreter's libpython where that is a shared library; where that link
fails, the library is built without it and takes the CPython symbols
from the process that loads it. `load_library(device=)` builds it if
needed, sets the bridge's device (None: the CUDA card; "cpu": the
kernels' plain versions) and loads it with RTLD_LOCAL, so its LGBM_*
symbols never meet those of the JAX package's lib_lightgbm.so.

    from lightgbm_tpu_torch import native
    lib = native.load_library(device="cpu")
    lib.LGBM_DatasetCreateFromMat(...)
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "c_api_shim.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "csrc", "build")
LIBRARY_NAME = "lib_lightgbm_torch.so"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")


def _python_flags():
    """(compile flags, link flags) of the running interpreter."""
    include = [f"-I{sysconfig.get_paths()['include']}"]
    link = []
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        libdir = sysconfig.get_config_var("LIBDIR")
        link = [f"-L{libdir}",
                f"-lpython{sysconfig.get_config_var('LDVERSION')}",
                f"-Wl,-rpath,{libdir}"]
    return include, link


def library_path():
    """Where the library of this source, these flags and this
    interpreter lives."""
    include, link = _python_flags()
    digest = hashlib.sha256(" ".join(
        (*CXXFLAGS, *include, *link, sys.version)).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"capi_{digest.hexdigest()[:16]}",
                        LIBRARY_NAME)


def build_library():
    """Compile the library unless it exists; returns its path. Raises
    with the compiler's output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    include, link = _python_flags()
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, *include, SOURCE,
           "-o", tmp]
    res = subprocess.run(cmd + link, capture_output=True, text=True)
    if res.returncode != 0 and link:
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {LIBRARY_NAME} failed:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a reader never sees half a file
    return path


def load_library(device=None):
    """The built library, loaded with RTLD_LOCAL, its bridge on
    `device`."""
    from .. import capi_bridge
    capi_bridge.DEVICE = device
    lib = ctypes.CDLL(build_library(), mode=os.RTLD_LOCAL)
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    return lib
