"""Top-level transcoder: multiplex audio + video into an `.a2m` stream.

Orchestrates the full pipeline (reference transcoder/movie.py + main.py):
ingest frames (frames.py) -> build/load edit-distance tables (ops/editdist)
-> plan the opcode schedule (encoder.plan_movie) -> run the whole-movie
encode scan on the accelerator -> merge with audio levels -> emit the framed
byte stream (stream/framing.py).
"""

import os
import time
from typing import Iterator, Optional

import numpy as np

from iivision_tpu import audio as audio_mod
from iivision_tpu import encoder, frames
from iivision_tpu.palettes import Palette
from iivision_tpu.stream.framing import StreamFramer
from iivision_tpu.stream.opcodes import Header
from iivision_tpu.video_mode import VideoMode

# In-memory sources with more encoded frames than this use the segmented
# streaming encoder (encoder.encode_movie_streaming); at or below it, one
# unchunked whole-movie scan saves the per-segment round trips.
STREAM_MIN_FRAMES = 256


def get_distance(mode: VideoMode, palette: Palette,
                 model: str = "window"):
    """Distance model for the encoder (store-cost slab, built in seconds).

    The reference-compatible full LUT npz artifacts remain available via
    ops/editdist (build_tables/save_tables) but the encoder does not need
    them - it computes distances on the fly (see ops/distance.py).
    model='yiq' selects the NTSC-composite basis (ops/yiq.py).
    """
    from iivision_tpu.ops import distance

    return distance.ComputedDistance(mode, palette, model)


class Movie:
    def __init__(
            self,
            filename: Optional[str] = None,
            every_n_video_frames: int = 1,
            audio_bitrate: int = 14700,
            audio_normalization: Optional[float] = None,
            max_bytes_out: Optional[int] = None,
            video_mode: VideoMode = VideoMode.DHGR,
            palette: Palette = Palette.NTSC,
            dither_mode: str = "ordered",
            k: int = 8,
            j: int = 1,
            seed: int = 0,
            frames_source=None,
            audio_source: Optional[audio_mod.Audio] = None,
            dist=None,
            frame_rate: Optional[float] = None,
            chunk_frames: Optional[int] = None,
            colour_model: str = "window",
            stream_chunk_frames: int = 64,
            joint_content: bool = False,
    ):
        self.filename = filename
        self.every_n_video_frames = every_n_video_frames
        self.max_bytes_out = max_bytes_out
        self.video_mode = video_mode
        self.palette = palette
        self.dither_mode = dither_mode
        self.k = k
        self.j = j
        self.seed = seed
        # joint content selection (reference README.md:212-215 "Global
        # optimization"): opt-in, slower, scores >= greedy per op
        self.joint_content = joint_content
        # segment very long movies so device-resident targets stay bounded
        # in HBM; None = auto (chunk past 1024 encoded frames)
        self.chunk_frames = chunk_frames
        self.stream_chunk_frames = stream_chunk_frames
        self.timings = {}

        t0 = time.time()
        source = frames_source if frames_source is not None else filename
        # streaming transcode: for in-memory sources with the ordered
        # dither, defer ingestion into encode_ops so host quantization of
        # segment i+1 overlaps the device encode of segment i
        # (encoder.encode_movie_streaming); bit-identical output.
        self._stream_source = None
        if (isinstance(source, np.ndarray) and dither_mode == "ordered"
                and chunk_frames is None):
            self._stream_source = source
            self.frames = None
            self._n_frames_total = len(source)
            self._input_rate = float(frame_rate or 30.0)
        else:
            self.frames = frames.ingest(
                source, video_mode, palette,
                every_n_video_frames=every_n_video_frames,
                dither_mode=dither_mode,
                frame_rate=frame_rate)
            self._n_frames_total = self.frames.n_frames_total
            self._input_rate = self.frames.input_frame_rate
        self.timings["frames_s"] = time.time() - t0

        t0 = time.time()
        if audio_source is not None:
            self.audio = audio_source
        else:
            try:
                self.audio = audio_mod.Audio(
                    filename, bitrate=audio_bitrate,
                    normalization=audio_normalization)
            except Exception:
                # no audio track: silent stream covering the whole video
                seconds = (self._n_frames_total / self._input_rate)
                self.audio = audio_mod.Audio(
                    data=np.zeros(int(seconds * audio_bitrate) + 1,
                                  np.float32),
                    rate=audio_bitrate, bitrate=audio_bitrate,
                    normalization=1.0)
        self.timings["audio_s"] = time.time() - t0

        t0 = time.time()
        self.dist = dist if dist is not None else get_distance(
            video_mode, palette, colour_model)
        self.timings["tables_s"] = time.time() - t0

    def _set_final(self, fin_main, fin_aux, lazy: bool = False):
        """Record the encoder's final screen state.

        lazy=True keeps the (32, 256) banks on device and fetches only
        when final_main/final_aux are first read - producing the .a2m
        does not need them."""
        if lazy:
            self._fin_main, self._fin_aux = None, None
            self._fin_dev = (fin_main, fin_aux)
        else:
            self._fin_main = np.asarray(fin_main)
            self._fin_aux = np.asarray(fin_aux)
            self._fin_dev = None

    @property
    def final_main(self) -> np.ndarray:
        if self._fin_main is None:
            self._fin_main = np.asarray(self._fin_dev[0])
        return self._fin_main

    @property
    def final_aux(self) -> np.ndarray:
        if self._fin_aux is None:
            self._fin_aux = np.asarray(self._fin_dev[1])
        return self._fin_aux

    def encode_ops(self):
        """Run the encoder; returns (flat ops (n,6), audio levels (n,))."""
        t0 = time.time()
        levels = np.asarray(self.audio.levels())
        plan, n_enc = encoder.plan_movie(
            n_frames=self._n_frames_total,
            n_audio_ticks=len(levels),
            input_frame_rate=self._input_rate,
            ticks_per_second=self.audio.sample_rate,
            every_n_video_frames=self.every_n_video_frames,
            mode=self.video_mode, k=self.k, j=self.j)
        self.timings["plan_s"] = time.time() - t0

        dev_targets = None
        if self._stream_source is not None:
            t0 = time.time()
            gen = frames.ingest_stream_array(
                self._stream_source, self.video_mode, self.palette,
                every_n_video_frames=self.every_n_video_frames)
            if n_enc > STREAM_MIN_FRAMES:
                # long movie: segmented streaming encode - bounded device
                # memory, host quantize of segment i+1 overlapping the
                # device scan of segment i
                ops_dev, fin_main, fin_aux, tm, ta = \
                    encoder.encode_movie_streaming(
                        self.dist, gen, plan, self.video_mode,
                        seed=self.seed,
                        chunk_frames=self.stream_chunk_frames,
                        joint=self.joint_content)
                self.frames = frames.MovieFrames(
                    targets_main=tm, targets_aux=ta,
                    n_frames_total=self._n_frames_total,
                    input_frame_rate=self._input_rate)
                flat = encoder.flatten_ops(np.asarray(ops_dev), plan)
                self.timings["encode_s"] = time.time() - t0
                self._set_final(fin_main, fin_aux)
                self.plan = plan
                return flat, levels[:plan.n_ops]
            # short movie: materialize targets and run the single
            # unchunked whole-movie scan (no per-segment round trips).
            # THREE stages overlap: the producer threads' C++
            # resize+quantize of part i+1, this thread's bookkeeping, and
            # the io_pool's device_put of part i (the copy releases the
            # GIL) - so by the time quantization finishes, the targets
            # are already device-resident and the encode path skips its
            # upload entirely.
            import jax
            import jax.numpy as jnp

            from iivision_tpu.parallel.mesh import io_pool

            pool = io_pool()
            F_use = max(n_enc, 1)
            host_parts = []
            put_futs = []  # (fut_main, fut_aux|None) per uploaded part
            off = 0
            for pm, pa in gen:
                host_parts.append((pm, pa))
                lo, hi = off, off + len(pm)
                off = hi
                lo_c, hi_c = min(lo, F_use), min(hi, F_use)
                if hi_c > lo_c:  # only encoded frames cross the link
                    fm = pool.submit(jax.device_put, pm[lo_c - lo:hi_c - lo])
                    fa = None
                    if pa is not None:
                        fa = pool.submit(jax.device_put,
                                         pa[lo_c - lo:hi_c - lo])
                    put_futs.append((fm, fa))
            tm = np.concatenate([m for m, _ in host_parts]) \
                if len(host_parts) > 1 else host_parts[0][0]
            ta = None
            if self.video_mode == VideoMode.DHGR:
                ta = np.concatenate([a for _, a in host_parts]) \
                    if len(host_parts) > 1 else host_parts[0][1]
            self.frames = frames.MovieFrames(
                targets_main=tm, targets_aux=ta,
                n_frames_total=self._n_frames_total,
                input_frame_rate=self._input_rate)
            # program-bucketing pad (repeat the last encoded frame to a
            # multiple of 16), uploaded as one extra small part - exactly
            # prepare_targets_jit's host-side pad, done link-side
            pad = (-F_use) % 16
            if pad:
                fm = pool.submit(jax.device_put,
                                 np.repeat(tm[F_use - 1:F_use], pad, 0))
                fa = None
                if ta is not None:
                    fa = pool.submit(jax.device_put,
                                     np.repeat(ta[F_use - 1:F_use], pad, 0))
                put_futs.append((fm, fa))
            d_main = [f.result() for f, _ in put_futs]
            d_main = jnp.concatenate(d_main) if len(d_main) > 1 \
                else d_main[0]
            d_aux = None
            if self.video_mode == VideoMode.DHGR:
                d_aux = [f.result() for _, f in put_futs]
                d_aux = jnp.concatenate(d_aux) if len(d_aux) > 1 \
                    else d_aux[0]
            dev_targets = (d_main, d_aux)
            self.timings["frames_s"] += time.time() - t0

        assert n_enc <= len(self.frames.targets_main), (
            n_enc, len(self.frames.targets_main))
        tgt_main = self.frames.targets_main[:max(n_enc, 1)]
        tgt_aux = (None if self.frames.targets_aux is None
                   else self.frames.targets_aux[:max(n_enc, 1)])
        chunk = self.chunk_frames
        if chunk is not None and chunk <= 0:
            raise ValueError("chunk_frames must be positive, got %r"
                             % (chunk,))
        if chunk is None and n_enc > 1024:
            chunk = 512  # auto-segment long movies
        t0 = time.time()
        if chunk:
            ops_dev, fin_main, fin_aux = encoder.encode_movie_chunked(
                self.dist, tgt_main, tgt_aux, plan, self.video_mode,
                seed=self.seed, chunk_frames=chunk,
                joint=self.joint_content)
        else:
            if dev_targets is not None:
                # targets already device-resident (uploaded part-by-part
                # during host quantization above): lane prep is fused
                # into the encode program (one dispatch), ops come back
                # as FETCH_SPLITS flat parts fetched concurrently, and the
                # final screens stay on device until someone actually
                # reads them (lazy properties)
                from iivision_tpu.parallel.mesh import io_pool

                parts, fin_main, fin_aux = encoder.encode_movie_from_frames(
                    self.dist, dev_targets[0], dev_targets[1],
                    plan, self.video_mode, seed=self.seed,
                    joint=self.joint_content)
                fetched = list(io_pool().map(np.asarray, parts))
                flat = encoder.flatten_ops(
                    encoder.ops_from_parts(fetched, plan), plan)
                self.timings["encode_s"] = time.time() - t0
                self._set_final(fin_main, fin_aux, lazy=True)
                self.plan = plan
                return flat, levels[:plan.n_ops]
            lanes_tgt, bytes_tgt = encoder.prepare_targets_jit(
                tgt_main, tgt_aux, self.video_mode)
            ops_dev, fin_main, fin_aux = encoder.encode_movie(
                self.dist, lanes_tgt, bytes_tgt, plan, self.video_mode,
                seed=self.seed, joint=self.joint_content)
        flat = encoder.flatten_ops(np.asarray(ops_dev), plan)
        self.timings["encode_s"] = time.time() - t0
        self._set_final(fin_main, fin_aux)
        self.plan = plan
        return flat, levels[:plan.n_ops]

    def emit_stream(self) -> Iterator[bytes]:
        """Full byte stream for the movie (header, ticks, ACKs, padding)."""
        flat, levels = self.encode_ops()
        framer = StreamFramer(self.video_mode,
                              max_bytes_out=self.max_bytes_out)

        def op_iter():
            yield Header(self.video_mode)
            yield from encoder.ops_to_ticks(flat, levels)

        yield from framer.emit_stream(op_iter())

    def transcode(self, out_path: str) -> dict:
        """Encode to a file (vectorized emission); returns timing stats."""
        from iivision_tpu.stream.emit_fast import emit_stream_fast

        flat, levels = self.encode_ops()
        t0 = time.time()
        data = emit_stream_fast(flat, levels, self.video_mode,
                                max_bytes_out=self.max_bytes_out)
        with open(out_path, "wb") as f:
            f.write(data)
        self.timings["emit_s"] = time.time() - t0
        n_ops = self.plan.n_ops
        movie_seconds = n_ops / self.audio.sample_rate
        total = sum(self.timings.values())
        self.timings.update(
            n_ops=n_ops, movie_seconds=movie_seconds,
            total_s=total,
            realtime_x=movie_seconds / total if total > 0 else 0.0)
        return dict(self.timings)
