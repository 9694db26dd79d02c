"""CLI: generate distance-model artifacts.

Two artifact families:

1. `--what luts` - reference-compatible edit-distance LUT npz files, the
   equivalent of the reference's `make_data_tables.py` (~90 minutes on CPU,
   reference README.md:61-67); here one batched device program per
   mode/palette.
   Drop-in replacements for the reference's transcoder/data/*.npz
   (upper-triangle layout, symmetrised at load).  The encoder itself
   does NOT need these - they exist for reference-toolchain interop.
2. `--what store_cost` - the store-cost tables that ARE the encoder's
   distance model (ops/distance.py).  The common configs ship with the
   package (data/store_cost/), so a fresh clone pays ~0.1s npz load
   instead of an on-device build at first use.

Default generates both for NTSC+IIGS, HGR+DHGR.

Usage:
    python -m iivision_tpu.make_tables [--data_dir DIR] [--modes HGR DHGR]
        [--palettes NTSC IIGS] [--what luts store_cost] [--models window yiq]
"""

import argparse
import time

import numpy as np

from iivision_tpu.ops import distance, editdist
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode


def main(args=None):
    parser = argparse.ArgumentParser(
        description="Generate (D)HGR distance-model artifacts.")
    parser.add_argument("--data_dir", default=None,
                        help="Output directory (default: package data/).")
    parser.add_argument("--modes", nargs="+", default=["HGR", "DHGR"],
                        choices=[m.name for m in VideoMode])
    parser.add_argument("--palettes", nargs="+", default=["NTSC", "IIGS"],
                        choices=[p.name for p in Palette if p.value >= 0])
    parser.add_argument("--what", nargs="+",
                        default=["luts", "store_cost"],
                        choices=["luts", "store_cost"])
    parser.add_argument("--models", nargs="+", default=["window"],
                        choices=["window", "yiq"],
                        help="Colour models for store-cost artifacts.")
    a = parser.parse_args(args)

    if a.data_dir is None:
        # installed wheels live in a read-only site-packages: the default
        # destination must then be the user cache (where the loaders also
        # look), not the package data/ dir
        import os

        from iivision_tpu.ops.distance import DATA_DIR, _user_cache_dir
        if not os.access(DATA_DIR, os.W_OK):
            a.data_dir = _user_cache_dir()
            os.makedirs(a.data_dir, exist_ok=True)
            print("package data/ not writable; writing artifacts to %s"
                  % a.data_dir)

    for pal_name in a.palettes:
        for mode_name in a.modes:
            mode, pal = VideoMode[mode_name], Palette[pal_name]
            if "store_cost" in a.what:
                for model in a.models:
                    t0 = time.time()
                    cost = np.asarray(
                        distance._build_store_cost(mode, pal, model))
                    t_build = time.time() - t0
                    path = distance.save_store_cost(
                        cost, mode, pal, model, a.data_dir)
                    print("store_cost %s/%s/%s: built %.1fs -> %s"
                          % (mode_name, pal_name, model, t_build, path))
            if "luts" in a.what:
                t0 = time.time()
                tables = editdist.build_tables(mode, pal)
                tables.block_until_ready()
                t_build = time.time() - t0
                t0 = time.time()
                path = editdist.save_tables(tables, mode, pal, a.data_dir)
                print("%s/%s: built %.1fs, saved %.1fs -> %s"
                      % (mode_name, pal_name, t_build,
                         time.time() - t0, path))
                del tables


if __name__ == "__main__":
    main()
