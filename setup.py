"""Packaging (reference parity: setup.py + cmake/pip_install).

The package is pure Python over jax; the optional native core
(src/ffcore/libffcore.so) is auto-built on first use by
flexflow_tpu.native.ensure_built() and is not required for any feature
(pure-Python fallbacks exist)."""
from setuptools import find_packages, setup

setup(
    name="flexflow-tpu",
    version="0.1.0",
    description=(
        "TPU-native automatic-parallelization DNN framework with the "
        "capabilities of FlexFlow/Unity (JAX/XLA/Pallas/pjit)"
    ),
    packages=find_packages(include=["flexflow_tpu", "flexflow_tpu.*",
                                    "flexflow_tpu_torch",
                                    "flexflow_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={
        "frontends": ["torch", "onnx"],
        "checkpoint": ["orbax-checkpoint"],
    },
    include_package_data=True,
)
