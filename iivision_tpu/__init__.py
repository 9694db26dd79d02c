"""ii-vision-tpu: a JAX/XLA Apple II streaming-video transcoder.

A from-scratch rebuild of the capabilities of KrisKennaway/ii-vision as an
accelerator-first framework (the package name records where it started):

- the NTSC sliding-window colour model and CIE2000 perceptual metric
  (`colours`, `palettes`) are pure functions over arrays;
- screen memory is modelled as raw byte arrays with *functionally derived*
  masked bit-lanes (`screen`) instead of the reference's stateful packed-uint64
  columns (reference transcoder/screen.py:128-341) - the lane form turns
  every hot operation into int32 vector ops + gathers;
- the perceptual edit-distance tables (reference transcoder/make_data_tables.py,
  ~90 min of Cython DP on CPU) are generated by a matmul reformulation of
  the Damerau-Levenshtein recurrence (`ops.editdist`);
- the per-frame greedy byte scheduler (reference transcoder/video.py:95-251,
  Python heapq) becomes a page-parallel `lax.scan` program that encodes an
  entire movie in one XLA program (`encoder`);
- the emitted `.a2m` opcode byte stream stays playback-compatible with the
  unmodified 6502 player: the opcode ISA, cc65 symbol-table coupling, 2KB/ACK
  framing and terminate/padding contracts are frozen (`stream`);
- a native C++ player VM (`sim`) decodes and validates emitted streams at
  memory-image level, completing the verification loop the reference left
  unfinished (reference simulator/).
"""

__version__ = "0.1.0"


import os as _os

# the checkout (or install prefix) holding this package
_CHECKOUT_DIR = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=None, platforms=None):
    """Where JAX's persistent compilation cache goes, or None to set none.

    - ``JAX_COMPILATION_CACHE_DIR`` set: None.  JAX reads that variable
      itself, and this package sets no other directory.
    - The CPU backend pinned (``platforms`` or ``JAX_PLATFORMS`` starting
      with ``cpu``, as in the test suite and the multi-device dry run):
      None.  XLA:CPU executables bake in the compiling host's CPU
      features, which JAX's cache key does not include, so a shared
      cache could serve wrong-ISA code to another host, and even
      same-host reloads warn.  CPU compiles are local and cheap.
    - Otherwise: the fixed ``<checkout>/.jax_cache``.  The path is part of
      the cache's identity, so it never depends on a temp name, pid,
      time or host.
    - ``IIVISION_NO_COMPILE_CACHE=1``: None.
    """
    environ = _os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR") or \
            environ.get("IIVISION_NO_COMPILE_CACHE"):
        return None
    plats = platforms or environ.get("JAX_PLATFORMS") or ""
    if plats.split(",")[0].strip().lower() == "cpu":
        return None
    return _os.path.join(_CHECKOUT_DIR, ".jax_cache")


def _enable_persistent_compile_cache():
    """Point JAX's persistent compilation cache at compile_cache_dir().

    The encode scan's first compile takes long enough that CLI runs,
    benches and tests should load it from disk in later processes."""
    try:
        import jax
    except ImportError:  # pragma: no cover - jax absent
        return
    cache = compile_cache_dir(platforms=jax.config.jax_platforms)
    if cache is not None:
        jax.config.update("jax_compilation_cache_dir", cache)


def _disable_numpy_hugepage_madvise():
    """Default NUMPY_MADVISE_HUGEPAGE=0 before numpy first loads.

    numpy madvises MADV_HUGEPAGE on large buffers; with the kernel's THP
    defrag mode at `madvise`, every 2MB fault on a madvised region does
    SYNCHRONOUS compaction.  On a long-running fragmented host this
    measured ~25us per 4KB fault - a fresh 200MB numpy buffer took 4.3s
    to first-touch vs 0.10s without the madvise (40x), which poisoned
    every host stage that allocates big arrays (frame synthesis, decode
    buffers, target assembly).  Opt back in with NUMPY_MADVISE_HUGEPAGE=1.
    """
    import sys

    if "numpy" not in sys.modules:  # too late otherwise; harmless to skip
        _os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")


_enable_persistent_compile_cache()
_disable_numpy_hugepage_madvise()

from iivision_tpu.video_mode import VideoMode  # noqa: F401
from iivision_tpu.palettes import Palette  # noqa: F401
