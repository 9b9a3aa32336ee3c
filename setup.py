import os

from setuptools import find_packages, setup

version = {}
with open(os.path.join(os.path.dirname(__file__), "mural_tpu",
                       "_version.py")) as fh:
    exec(fh.read(), version)

setup(
    name="mural-tpu",
    version=version["__version__"],
    description=("TPU-native framework for base-resolution germline "
                 "mutation rate estimation (MuRaL-compatible)"),
    packages=find_packages(include=["mural_tpu", "mural_tpu.*",
                                    "mural_tpu_torch", "mural_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "pandas", "scipy"],
    scripts=["bin/mural_snv", "bin/mural_indel"],
    entry_points={
        "console_scripts": [
            "mural_snv_tpu=mural_tpu.cli.mural_snv:main",
            "mural_indel_tpu=mural_tpu.cli.mural_indel:main",
        ]
    },
    package_data={"mural_tpu.native": ["encoder.cpp"],
                  "mural_tpu_torch.ops": ["csrc/*.cu"]},
)
