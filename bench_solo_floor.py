"""Solo-encode latency decomposition.

Measures where the single-movie encode's remaining wall time lives by
timing the SAME device-resident encode program across movie lengths and
scan unroll factors:

- slope vs n_ops  -> per-sub-op-iteration cost (the sequential floor);
- intercept       -> fixed dispatch + h2d/d2h overhead per encode;
- unroll sweep    -> how much of the per-iteration cost is loop/kernel
                     overhead (latency) vs real math.

Prints one JSON line per movie length and one for the fit.
"""

import json
import os
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from iivision_tpu import encoder
    from iivision_tpu.movie import get_distance
    from iivision_tpu.palettes import Palette
    from iivision_tpu.video_mode import VideoMode

    mode, pal = VideoMode.DHGR, Palette.NTSC
    dist = get_distance(mode, pal)
    unroll = int(os.environ.get("IIVISION_SCAN_UNROLL", "1"))

    rows = []
    for seconds in (2.5, 5.0, 10.0):
        n_frames = int(seconds * 30)
        plan, n_enc = encoder.plan_movie(
            n_frames=n_frames, n_audio_ticks=int(seconds * 14700),
            input_frame_rate=30.0, ticks_per_second=14700.0,
            every_n_video_frames=2, mode=mode, k=32, j=10)
        rng = np.random.RandomState(int(seconds * 7))
        fm = rng.randint(0, 0x80, (n_enc, 32, 256)).astype(np.uint8)
        fa = rng.randint(0, 0x80, (n_enc, 32, 256)).astype(np.uint8)
        lanes, bytes_ = encoder.prepare_targets_jit(fm, fa, mode)
        jax.block_until_ready((lanes, bytes_))
        # warm; every timed rep fetches the final 8KB screen bank
        ops, m_, a_ = encoder.encode_movie(dist, lanes, bytes_, plan, mode,
                                           seed=1)
        np.asarray(m_)
        best = 1e9
        for rep in range(4):
            t0 = time.time()
            ops, m_, a_ = encoder.encode_movie(dist, lanes, bytes_, plan,
                                               mode, seed=2 + rep)
            np.asarray(m_)
            best = min(best, time.time() - t0)
        (sfp, _, _, _), _ = encoder.pad_plan_steps(plan)
        S = len(sfp)
        subops = S * plan.j
        rec = {"seconds": seconds, "unroll": unroll, "best_s": round(best, 4),
               "S": S, "subops": subops,
               "us_per_subop": round(best / subops * 1e6, 2),
               "n_ops": plan.n_ops, "ts": time.time()}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    # linear fit: best_s = intercept + slope * subops
    xs = np.array([r["subops"] for r in rows], np.float64)
    ys = np.array([r["best_s"] for r in rows], np.float64)
    slope, intercept = np.polyfit(xs, ys, 1)
    fit = {"fit": True, "unroll": unroll,
           "us_per_subop_marginal": round(slope * 1e6, 2),
           "intercept_ms": round(intercept * 1e3, 1), "ts": time.time()}
    print(json.dumps(fit), flush=True)


if __name__ == "__main__":
    main()
