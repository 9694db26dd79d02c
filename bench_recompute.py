"""Recompute-cost attribution for the batched encode scan (diagnostic).

Times the B=32 DHGR encode with pieces of the chunk-start recompute ablated
(encoder._build_encode_scan's diag knob) to attribute the per-chunk cost:

  full            the production program
  nolanes         skip current-screen lane derivation (DP on tgt vs tgt)
  nodp            skip the diff DP entirely (and lane derivation with it)
  noslab          keep the carried cost slab instead of rebuilding
  nodp,noslab     recompute reduced to bookkeeping - the scan's floor

Ablated programs produce WRONG streams; this script is timing-only.
Prints one JSON line per variant.
"""

import json
import os
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import numpy as np

VARIANTS = os.environ.get("IIVISION_DIAG_VARIANTS", "full").split(";")
B = int(os.environ.get("IIVISION_DIAG_B", "32"))
REPS = 3


def main():
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    import jax
    import jax.numpy as jnp

    from bench import synth_movies_device, CLIP_SECONDS, FPS
    from iivision_tpu import encoder
    from iivision_tpu.movie import get_distance
    from iivision_tpu.palettes import Palette
    from iivision_tpu.parallel import mesh as pmesh
    from iivision_tpu.video_mode import VideoMode

    mode, pal = VideoMode.DHGR, Palette.NTSC
    dist = get_distance(mode, pal)
    n_frames = int(CLIP_SECONDS * FPS)
    plan, _ = encoder.plan_movie(
        n_frames=n_frames, n_audio_ticks=int(CLIP_SECONDS * 14700),
        input_frame_rate=FPS, ticks_per_second=14700.0,
        every_n_video_frames=2, mode=mode,
        k=int(os.environ.get("IIVISION_DIAG_K", "16")),
        j=int(os.environ.get("IIVISION_DIAG_J", "4")))
    (sf, sb, sr, sn), _ = encoder.pad_plan_steps(plan)
    F_enc = -(-n_frames // 2)

    src = synth_movies_device(B, F_enc, 3.0)
    lanes_b, bytes_b = pmesh.ingest_movies_batch(src, mode, pal)
    jax.block_until_ready((lanes_b, bytes_b))
    store_cost = jnp.asarray(dist.store_cost)
    sub = jnp.asarray(dist.sub)
    sfj, sbj = jnp.asarray(sf), jnp.asarray(sb)
    srj, snj = jnp.asarray(sr), jnp.asarray(sn)

    results = {}
    for variant in VARIANTS:
        diag = "" if variant == "full" else variant
        scan = encoder._build_encode_scan(mode, plan.k, False, plan.j,
                                          plan.chunk_steps, diag=diag)
        fn = jax.jit(jax.vmap(
            scan, in_axes=(None, None, 0, 0, None, None, None, None, 0)))
        def timed(keys):
            t0 = time.time()
            ops, _, _ = fn(store_cost, sub, lanes_b, bytes_b,
                           sfj, sbj, srj, snj, keys)
            np.asarray(ops[-1, -1])
            return time.time() - t0

        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B))
        compile_s = timed(keys)
        best = 1e9
        for rep in range(REPS):
            keys = jax.vmap(jax.random.PRNGKey)(
                jnp.arange(B) + 1000 * (rep + 1))
            best = min(best, timed(keys))
        results[variant] = best
        rec = {"variant": variant, "best_s": round(best, 4),
               "compile_s": round(compile_s, 1), "B": B,
               "k": plan.k, "j": plan.j, "ts": time.time()}
        print(json.dumps(rec), flush=True)

    full = results.get("full")
    if full:
        log("--- attribution (of %.3fs full) ---" % full)
        for v, t in results.items():
            if v != "full":
                log("  %-12s -%.3fs (%.0f%%)"
                    % (v, full - t, 100 * (full - t) / full))


if __name__ == "__main__":
    main()
