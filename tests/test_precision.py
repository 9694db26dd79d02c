"""Precision audit of the device path.

On a GPU a float32 dot with default precision may run in TF32, which keeps
10 mantissa bits.  Every f32 dot_general the device path traces must
therefore either ask for HIGHEST precision or sit in
distance.EXACT_INT_SCOPE, the named scope of the dots whose operands are
small integers that TF32 and bf16 hold exactly (the proofs are comments
at ops/distance.py dist_pixel_pairs and ops/editdist.py dp_distance_tile).
"""

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jex_core

from iivision_tpu import encoder
from iivision_tpu.ops import distance
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode


def _sub_jaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, jex_core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex_core.Jaxpr):
                yield x


def _f32_dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype == jnp.float32 for v in eqn.invars):
            yield eqn
        for sub in _sub_jaxprs(eqn.params):
            yield from _f32_dots(sub)


def _loose_dots(closed):
    """The f32 dots that are neither HIGHEST nor in the exact scope."""
    highest = jax.lax.Precision.HIGHEST
    out, n = [], 0
    for eqn in _f32_dots(closed.jaxpr):
        n += 1
        prec = eqn.params.get("precision")
        if isinstance(prec, tuple) and all(p == highest for p in prec):
            continue
        if distance.EXACT_INT_SCOPE in str(eqn.source_info.name_stack):
            continue
        out.append((str(eqn.source_info.name_stack), prec))
    assert n > 0, "no f32 dot traced: the walk is broken"
    return out


def _encode_jaxpr(mode, model):
    plan, n_enc = encoder.plan_movie(
        n_frames=2, n_audio_ticks=700, input_frame_rate=6.0,
        ticks_per_second=2100.0, every_n_video_frames=1, mode=mode, k=4,
        j=2)
    n_lanes = 4 if mode == VideoMode.DHGR else 2
    C = distance.n_contents(mode)
    bits = 13 if mode == VideoMode.DHGR else 14
    sub = distance.sub_for(mode, Palette.NTSC, model)
    scan = encoder._build_encode_scan(mode, plan.k, False, plan.j,
                                      plan.chunk_steps)
    S = len(plan.step_frame)
    spec = jax.ShapeDtypeStruct
    return jax.make_jaxpr(scan)(
        spec((n_lanes, 1 << bits, C), jnp.float32),
        spec(sub.shape, jnp.float32),
        spec((n_enc, 32, 128, n_lanes), jnp.int32),
        spec((n_enc, 2, 32, 256), jnp.int32),
        spec((S,), jnp.int32), spec((S,), jnp.int32), spec((S,), jnp.bool_),
        spec((S,), jnp.int32), jax.random.PRNGKey(0))


@pytest.mark.parametrize("what", [
    "encode_window_dhgr", "encode_window_hgr", "encode_yiq_dhgr",
    "ingest_dhgr", "ingest_hgr", "store_cost_window", "store_cost_yiq",
    "tablegen"])
def test_f32_dots_are_highest_or_proven_exact(what):
    if what.startswith("encode_"):
        _, model, mode = what.split("_")
        closed = _encode_jaxpr(VideoMode[mode.upper()], model)
    elif what.startswith("ingest_"):
        from iivision_tpu.parallel import mesh

        mode = VideoMode[what.split("_")[1].upper()]
        fn = mesh._jitted_batch_ingest(mode, Palette.NTSC)
        closed = jax.make_jaxpr(fn)(
            jax.ShapeDtypeStruct((1, 2, 48, 64, 3), jnp.uint8))
    elif what.startswith("store_cost_"):
        model = what.split("_")[2]
        closed = jax.make_jaxpr(distance.store_cost_fn(
            VideoMode.DHGR, Palette.NTSC, model))()
    else:
        from iivision_tpu.ops import editdist

        codes = editdist.lane_pixel_codes(VideoMode.DHGR, 0)[:8]
        closed = jax.make_jaxpr(editdist.dp_distance_tile)(
            jnp.asarray(codes, jnp.int32), jnp.asarray(codes, jnp.int32),
            jnp.asarray(editdist.substitute_matrix(Palette.NTSC),
                        jnp.float32))
    assert _loose_dots(closed) == []


def test_exact_scope_covers_no_fractional_operand():
    """The exact scope must not swallow a dot with fractional operands:
    trace the yiq store-cost build and check none of its dots is there."""
    closed = jax.make_jaxpr(distance.store_cost_fn(
        VideoMode.DHGR, Palette.NTSC, "yiq"))()
    scoped = [e for e in _f32_dots(closed.jaxpr)
              if distance.EXACT_INT_SCOPE in str(e.source_info.name_stack)]
    assert scoped == []
