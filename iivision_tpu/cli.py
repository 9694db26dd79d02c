"""Transcode CLI (parity: reference transcoder/main.py flags).

Extends the reference CLI with a batch mode: pass several inputs and they
encode together in ONE vmapped device scan (parallel/mesh.encode_movies_mixed
pads to a shared dominating plan; each output is bit-identical to its padded
solo encode), sharing the chip the way the batched benchmarks do.
"""

import argparse
import os

from iivision_tpu.movie import Movie
from iivision_tpu.palettes import Palette
from iivision_tpu.video_mode import VideoMode


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Transcode videos to ][-Vision format.")
    parser.add_argument("input", nargs="+",
                        help="Input video file(s), or reference bmp2dhr "
                             "frame-cache directories "
                             "(<video>/<MODE>/<PALETTE> with "
                             "%%08d.BIN/.AUX dumps). Multiple inputs "
                             "batch-encode in one device scan.")
    parser.add_argument("--frame_rate", type=float, default=None,
                        help="Override the probed input frame rate "
                             "(required context for frame-cache dirs).")
    parser.add_argument("--output", default=None,
                        help="Path to output video file (single input) or "
                             "output directory (multiple inputs).")
    parser.add_argument("--max_output_mb", type=float, default=0,
                        help="Maximum MB to output (0 = unlimited).")
    parser.add_argument("--audio_normalization", type=float, default=None,
                        help="Override auto-detected audio normalization.")
    parser.add_argument("--audio_bitrate", type=int, default=14700,
                        help="Output audio bitrate (Hz); 22500 for //gs "
                             "2.8MHz mode.")
    parser.add_argument("--every_n_video_frames", type=int, default=2,
                        help="Skip input frames to lower the effective "
                             "output frame rate.")
    parser.add_argument("--video_mode", type=str,
                        choices=[m.name for m in VideoMode],
                        default=VideoMode.DHGR.name)
    parser.add_argument("--palette", type=str,
                        choices=[p.name for p in Palette if p.value >= 0],
                        default=Palette.NTSC.name)
    parser.add_argument("--dither", type=str, default=None,
                        choices=["ordered", "buckels", "floyd", "atkinson",
                                 "jarvis", "mono"],
                        help="Frame quantization dither (ordered = batched "
                             "device path; others = native error diffusion; "
                             "mono = 1-bit 560-dot Bayer, auto-selected by "
                             "--colour_model mono).  Default: ordered.")
    parser.add_argument("--k", type=int, default=8,
                        help="Encoder page-parallelism (1 = strict greedy "
                             "order).")
    parser.add_argument("--j", type=int, default=1,
                        help="Ops per selected page per scan step "
                             "(ops/step = k*j; >1 trades a little "
                             "fidelity for encode speed).")
    parser.add_argument("--seed", type=int, default=0,
                        help="Tie-break RNG seed (reproducible streams).")
    parser.add_argument("--joint_content", action="store_true",
                        help="Joint content optimization (the reference's "
                             "'Global optimization' future improvement): "
                             "pick each op's content byte to maximize the "
                             "total improvement over its 4 offsets, "
                             "searching ALL content codes. Slower encode, "
                             "higher fidelity.")
    parser.add_argument("--colour_model", type=str, default="window",
                        choices=["window", "yiq", "mono"],
                        help="Perceptual basis: 'window' = the reference's "
                             "4-bit nominal colours; 'yiq' = NTSC composite "
                             "demodulation (wider chroma low-pass); 'mono' "
                             "= dot-level hamming for monochrome monitors "
                             "(pairs with the 1-bit mono dither).")
    parser.add_argument("--chunk_frames", type=int, default=None,
                        help="Encode in segments of this many frames "
                             "(bounded device memory for long movies; "
                             "default: auto past 1024 frames).")
    parser.add_argument("--stats_json", default=None,
                        help="Write per-movie transcode stats (stage "
                             "timings, op/byte counts) to this JSON file.")
    parser.add_argument("--mesh", default=None,
                        help="Shard batch encodes over a device mesh: a "
                             "device count or 'auto' (all devices).  The "
                             "effective size is clamped to the largest "
                             "divisor of each group's batch size; outputs "
                             "are bit-identical to unsharded encodes.")
    return parser


def _group_mesh(arg, batch_size: int):
    """Mesh for one batch group under --mesh, or None.

    The batch axis must divide evenly across devices, so the requested
    count is clamped to the largest divisor of the group size."""
    if arg is None:
        return None
    import jax

    from iivision_tpu.parallel import mesh as pmesh

    want = len(jax.devices()) if arg == "auto" else int(arg)
    n = max(d for d in range(1, min(want, batch_size) + 1)
            if batch_size % d == 0)
    if n <= 1:
        return None
    return pmesh.make_mesh(n)


def _default_out(path: str) -> str:
    base = path.rstrip("/")
    stem = base.rsplit(".", 1)[0] if "." in os.path.basename(base) else base
    return stem + ".a2m"


def transcode_batch(args):
    """Batch mode: N inputs -> N .a2m files via one vmapped device scan.

    Inputs are ingested individually (each pipelines its own decode +
    quantize), grouped by probed input frame rate (movies in a mixed
    batch must share the opcode schedule's timing), and each group
    encodes as one mesh.encode_movies_mixed call; per-movie audio is
    multiplexed at emission.
    """
    import numpy as np

    from iivision_tpu import audio as audio_mod, frames
    from iivision_tpu.movie import get_distance
    from iivision_tpu.parallel import mesh as pmesh
    from iivision_tpu.stream.emit_fast import emit_stream_fast

    mode = VideoMode[args.video_mode]
    palette = Palette[args.palette]
    dist = get_distance(mode, palette, args.colour_model)
    max_bytes = int(1024 * 1024 * args.max_output_mb) or None

    if args.output:
        os.makedirs(args.output, exist_ok=True)
    ingested = []
    for path in args.input:
        fr = frames.ingest(path, mode, palette,
                           every_n_video_frames=args.every_n_video_frames,
                           dither_mode=args.dither,
                           frame_rate=args.frame_rate)
        try:
            aud = audio_mod.Audio(path, bitrate=args.audio_bitrate,
                                  normalization=args.audio_normalization)
        except Exception:
            seconds = fr.n_frames_total / fr.input_frame_rate
            aud = audio_mod.Audio(
                data=np.zeros(int(seconds * args.audio_bitrate) + 1,
                              np.float32),
                rate=args.audio_bitrate, bitrate=args.audio_bitrate,
                normalization=1.0)
        out = (os.path.join(args.output, os.path.basename(_default_out(path)))
               if args.output else _default_out(path))
        if any(out == m[3] for m in ingested):
            raise ValueError(
                "output collision: %r would be written by two inputs "
                "(distinct inputs share a basename) - rename an input or "
                "use separate --output dirs" % (out,))
        ingested.append((path, fr, aud, out))

    groups = {}
    for i, (_, fr, _, _) in enumerate(ingested):
        groups.setdefault(round(fr.input_frame_rate, 6), []).append(i)
    stats_rows = []
    for rate, idxs in sorted(groups.items()):
        movies = [(ingested[i][1].targets_main, ingested[i][1].targets_aux,
                   ingested[i][1].n_frames_total,
                   len(ingested[i][2].levels())) for i in idxs]
        flats, _, n_ops = pmesh.encode_movies_mixed(
            dist, movies, mode, rate, float(args.audio_bitrate),
            every_n_video_frames=args.every_n_video_frames,
            k=args.k, j=args.j,
            seeds=[args.seed + i for i in idxs],
            joint=args.joint_content,
            mesh=_group_mesh(args.mesh, len(movies)))
        for flat, i in zip(flats, idxs):
            path, fr, aud, out = ingested[i]
            levels = np.asarray(aud.levels())[:len(flat)]
            data = emit_stream_fast(flat, levels, mode,
                                    max_bytes_out=max_bytes)
            with open(out, "wb") as f:
                f.write(data)
            print("Wrote %s (%d ops, %.1fs @ %.3f fps input)"
                  % (out, len(flat), len(flat) / args.audio_bitrate, rate))
            stats_rows.append({
                "input": path, "output": out, "n_ops": len(flat),
                "stream_bytes": len(data),
                "movie_seconds": len(flat) / args.audio_bitrate,
                "input_frame_rate": rate,
            })
    _write_stats(args.stats_json, stats_rows)
    return [m[3] for m in ingested]


def _write_stats(path, rows):
    if not path:
        return
    import json

    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print("Stats written to %s" % path)


def main(args=None):
    args = build_parser().parse_args(args)
    if args.dither is None:
        # the mono colour model pairs with the 1-bit mono quantizer
        args.dither = "mono" if args.colour_model == "mono" else "ordered"
    if len(args.input) > 1:
        transcode_batch(args)
        return
    args.input = args.input[0]
    out = args.output or _default_out(args.input)
    m = Movie(
        args.input,
        every_n_video_frames=args.every_n_video_frames,
        audio_bitrate=args.audio_bitrate,
        audio_normalization=args.audio_normalization,
        max_bytes_out=int(1024 * 1024 * args.max_output_mb) or None,
        video_mode=VideoMode[args.video_mode],
        palette=Palette[args.palette],
        dither_mode=args.dither,
        k=args.k,
        j=args.j,
        seed=args.seed,
        frame_rate=args.frame_rate,
        chunk_frames=args.chunk_frames,
        colour_model=args.colour_model,
        joint_content=args.joint_content,
    )
    print("Palette %s" % args.palette)
    print("Input frame rate = %f" % m.frames.input_frame_rate)
    stats = m.transcode(out)
    print("Wrote %s" % out)
    for k in ("n_ops", "movie_seconds", "total_s", "realtime_x"):
        print("%s = %s" % (k, stats[k]))
    _write_stats(args.stats_json,
                 [{"input": args.input, "output": out, **stats}])


if __name__ == "__main__":
    main()
