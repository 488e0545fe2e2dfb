"""Packaging + plugin registration.

Registers the executor in the entry-point group Covalent's plugin loader
scans — the same mechanism the reference uses at ``setup.py:36`` (plugin
module list) and ``setup.py:74-76`` (group
``covalent.executor.executor_plugins``) — so ``executor="tpu"`` resolves on
any Covalent server with this package installed.
"""

import os

from setuptools import find_packages, setup


def read_version() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "VERSION")) as f:
        return f.read().strip()


setup(
    name="covalent-tpu-plugin",
    version=read_version(),
    description="Covalent executor plugin dispatching electrons to Cloud TPU "
    "VMs and pod slices (JAX/XLA-native).",
    packages=find_packages(include=[
        "covalent_tpu_plugin", "covalent_tpu_plugin.*",
        "covalent_tpu_plugin_torch", "covalent_tpu_plugin_torch.*",
    ]),
    package_data={
        # The resident worker agent ships as C++ SOURCE and is compiled on
        # each worker by the executor's preflight (content-hash cached).
        "covalent_tpu_plugin": ["native/agent.cc"],
        # The PyTorch port's CUDA kernels ship as SOURCE too, compiled with
        # nvcc at first use (ops/_kernels.py).
        # Its copy of the native agent is compiled on each worker the same
        # way as the JAX package's.
        "covalent_tpu_plugin_torch": ["csrc/*.cu", "csrc/*.cuh", "native/agent.cc"],
    },
    include_package_data=True,
    python_requires=">=3.11",  # tomllib is stdlib from 3.11
    install_requires=[
        "cloudpickle>=2.0",
    ],
    extras_require={
        "covalent": ["covalent>=0.202.0,<1"],
        "ssh": ["asyncssh>=2.10.1"],
        "jax": ["jax", "flax", "optax"],
        "torch": ["torch"],
    },
    entry_points={
        "covalent.executor.executor_plugins": [
            "tpu = covalent_tpu_plugin.tpu",
            "gpu = covalent_tpu_plugin_torch.gpu",
        ],
    },
    classifiers=[
        "Programming Language :: Python :: 3",
        "Environment :: Console",
        "Topic :: System :: Distributed Computing",
    ],
)
