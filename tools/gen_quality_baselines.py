"""Regenerate the quality-matrix baseline (a DELIBERATE act).

Run on CPU (the gate runs on CPU in CI; GPU bit-equality is pinned
separately by chip_smoke.py's exactness phase):

    JAX_PLATFORMS=cpu python tools/gen_quality_baselines.py

Writes tests/data/quality_matrix_baseline.json.  Commit the new baseline
together with the change that moved quality and explain the trade in the
commit message - the matrix gate exists to make silent drift impossible,
not to make intentional improvement hard.
"""

import json
import os
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main():
    import jax

    # baselines are pinned on CPU (the backend the CI gate runs on), so
    # pin it here - this must happen before any jax op
    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        print("refusing: could not pin the CPU backend", file=sys.stderr)
        return 1

    from tests.quality_matrix_common import (ROWS, clip_blocks, clip_sweep,
                                             compute_row)

    clips = {"sweep": clip_sweep(), "blocks": clip_blocks()}
    rows = {}
    for key, clip_name, mode, pal, cm in ROWS:
        t0 = time.time()
        mean_err, final_err = compute_row(clips[clip_name], mode, pal, cm)
        rows[key] = {"mean_error": round(mean_err, 4),
                     "final_error": round(final_err, 4)}
        print("%-28s mean=%10.4f final=%10.4f (%.1fs)"
              % (key, mean_err, final_err, time.time() - t0), flush=True)

    out = {
        "note": "seeded (seed=0, k=16, j=4) replay CIE2000 lane errors for "
                "the 12-row config matrix; gate: mean_error must not "
                "regress >1% (tests/test_quality_matrix.py).  Regenerate "
                "with tools/gen_quality_baselines.py ON CPU and explain "
                "the quality trade in the commit.",
        "clips": "quality_matrix_common.clip_sweep/clip_blocks (pinned, "
                 "2.0s @ 30fps)",
        "audio": "440Hz sine 16000 amp, 14700Hz",
        "rows": rows,
    }
    path = os.path.join(_ROOT, "tests", "data",
                        "quality_matrix_baseline.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
