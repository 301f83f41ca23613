"""Wheel packaging for paddle_tpu (reference python/setup.py.in, which the
CMake build templates into the wheel recipe; here the package is pure
Python + small C sources built on demand, so a plain setuptools file
suffices).

Build a wheel:  python setup.py bdist_wheel
Dev install:    pip install -e .
"""
from setuptools import find_packages, setup

setup(
    name="paddle_tpu",
    version="0.1.0",
    description=("TPU-native deep-learning framework with the capabilities "
                 "of PaddlePaddle Fluid, re-architected on JAX/XLA"),
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    package_data={"paddle_tpu": ["native/*.cpp"],
                  "paddle_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    extras_require={
        "test": ["pytest"],
    },
)
