"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU so it is fast and deterministic, with 8 virtual
devices so the multi-device sharding paths compile and execute:

    JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'

Tests marked `gpu` rerun the exactness checks on an NVIDIA GPU.  They
decide inside a fixture whether a GPU is present and skip on the CPU.  On
a machine with a GPU, run them with both backends enabled:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu

A JAX_PLATFORMS set by the caller is kept; unset, it defaults to cpu.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# numpy's MADV_HUGEPAGE can trigger synchronous THP compaction per fault
# (40x fresh-buffer slowdown; see iivision_tpu/__init__.py)
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
