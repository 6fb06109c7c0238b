"""Package installer (parity with the reference's python-package/setup.py).

The library is pure Python on top of the baked-in jax stack; the C API
shim (`make` -> lib_lightgbm.so) is built separately and only needed by
ctypes consumers of the reference C surface.
"""

from setuptools import find_packages, setup

setup(
    name="lightgbm_tpu",
    version="0.1.0",
    description=("TPU-native gradient boosting framework with the "
                 "capability surface of early LightGBM"),
    packages=find_packages(include=["lightgbm_tpu", "lightgbm_tpu.*",
                                    "lightgbm_tpu_torch",
                                    "lightgbm_tpu_torch.*"]),
    # the port's CUDA sources, compiled with nvcc at first use, its C
    # API shim, compiled with g++ at first use, and its lint baseline
    package_data={"lightgbm_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                         "native/*.cpp",
                                         "analysis/lint_baseline.json"]},
    python_requires=">=3.10",
    install_requires=["numpy", "pandas", "jax"],
    # lightgbm_tpu_torch, the PyTorch/CUDA port, needs torch instead
    extras_require={"torch": ["torch"]},
)
