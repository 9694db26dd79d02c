"""Where the package puts JAX's persistent compilation cache."""

import os
import subprocess
import sys

import iivision_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_after_import(env_updates):
    """jax_compilation_cache_dir as a fresh process sees it after
    importing the package (no backend is initialised, so no device is
    needed)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "IIVISION_NO_COMPILE_CACHE")}
    env.update(env_updates)
    out = subprocess.run(
        [sys.executable, "-c",
         "import iivision_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_env_var_is_honoured(tmp_path):
    want = str(tmp_path / "cache")
    assert iivision_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": want}) is None
    assert _cache_dir_after_import(
        {"JAX_COMPILATION_CACHE_DIR": want}) == want


def test_fixed_checkout_path_without_env_var():
    fixed = os.path.join(REPO, ".jax_cache")
    assert iivision_tpu.compile_cache_dir({}) == fixed
    assert iivision_tpu.compile_cache_dir({}) == fixed  # same every call
    assert _cache_dir_after_import({}) == fixed
    assert _cache_dir_after_import({}) == fixed
    # the CPU backend keeps no cache (XLA:CPU code is host-specific)
    assert iivision_tpu.compile_cache_dir({"JAX_PLATFORMS": "cpu"}) is None
    assert _cache_dir_after_import({"JAX_PLATFORMS": "cpu"}) == "None"
