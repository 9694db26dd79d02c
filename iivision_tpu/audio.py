"""Audio pipeline: decode -> resample -> percentile-normalize -> 5-bit levels.

Parity with reference transcoder/audio.py:10-100:
- target sample rate 14700 Hz (44100/3) by default, 22500 for //gs 2.8MHz
  playback;
- normalization scales so the 0.5/99.5 percentiles of (the first ~10MB of)
  the signal reach full scale - <1% of samples clip;
- levels are int(sample * 16) truncated toward zero and clipped to -15..16,
  each level driving one 73-cycle speaker duty-cycle opcode.

On device: the resample is an FFT method (the reference uses
librosa res_type='scipy' == scipy.signal.resample, also FFT) implemented in
jax.numpy so it runs on-device; decode is scipy WAV or ffmpeg when present
(the reference needs ffmpeg via audioread just the same).

Long inputs stream: the reference decodes audio in bounded chunks
(reference audio.py:84-100); the one-shot FFT resample here would instead
materialize the whole signal and one giant device FFT (an hour of 44.1kHz
mono is a ~160M-sample transform).  Above STREAM_AUTO_SAMPLES, inputs whose
rate ratio is an integer (the production 44100 -> 14700 case) automatically
switch to a streaming polyphase decimator: chunked decode -> windowed-sinc
FIR decimation with carried history -> per-chunk level quantization, peak
memory O(chunk).  Every output sample is one dot(h, window) whose operands
are identical under any chunking, so the streamed level stream is
bit-identical to the same decimator run one-shot (pinned by tests); short
inputs keep the FFT path unchanged.
"""

import functools
import shutil
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

# beyond this many source samples (~6.3 min at 44.1kHz), integral-ratio
# inputs resample via the streaming polyphase path instead of one giant FFT
STREAM_AUTO_SAMPLES = 1 << 24
_STREAM_CHUNK = 1 << 21  # source samples per streamed chunk (~47.5s)


def decode_audio(filename: str) -> Tuple[np.ndarray, int]:
    """Decode an audio (or video) file to mono float32; returns (data, rate).

    WAV via scipy; anything else via ffmpeg when available.
    """
    if filename.lower().endswith(".wav"):
        from scipy.io import wavfile
        rate, data = wavfile.read(filename)
        data = data.astype(np.float32)
        if data.ndim == 2:
            data = data.mean(axis=1)
        # normalize integer formats to int16 scale like audioread does
        # (np.ptp: ndarray.ptp was removed in numpy 2.0)
        if data.max() > 2 ** 15 or data.min() < -2 ** 15:
            data = data / (np.ptp(data) / 2 ** 16 + 1e-9)
        return data, int(rate)
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "ffmpeg not available; only .wav input is supported natively "
            "(or pass raw samples to Audio(data=...))")
    out = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", filename, "-f", "s16le",
         "-ac", "1", "-ar", "44100", "-"],
        check=True, capture_output=True)
    return np.frombuffer(out.stdout, dtype=np.int16).astype(np.float32), 44100


def decode_audio_chunks(filename: str,
                        chunk_samples: int = _STREAM_CHUNK
                        ) -> Iterator[np.ndarray]:
    """Chunked mono float32 decode: bounded memory for hour-scale inputs.

    WAV (16-bit PCM) reads frames incrementally via the stdlib wave
    module; everything else streams from an ffmpeg pipe.  Yields float32
    arrays of up to chunk_samples samples at the file's native rate
    (use probe_audio_rate for the rate).
    """
    if filename.lower().endswith(".wav"):
        import wave
        with wave.open(filename, "rb") as w:
            nch = w.getnchannels()
            if w.getsampwidth() != 2:
                # uncommon widths fall back to the one-shot scipy reader
                data, _ = decode_audio(filename)
                for i in range(0, len(data), chunk_samples):
                    yield data[i:i + chunk_samples]
                return
            while True:
                raw = w.readframes(chunk_samples)
                if not raw:
                    return
                a = np.frombuffer(raw, np.int16).astype(np.float32)
                if nch > 1:
                    a = a.reshape(-1, nch).mean(axis=1)
                yield a
        return
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not available for %s" % filename)
    cmd = ["ffmpeg", "-v", "error", "-i", filename, "-f", "s16le",
           "-ac", "1", "-ar", "44100", "-"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    ok = False
    try:
        while True:
            raw = proc.stdout.read(chunk_samples * 2)
            if not raw:
                break
            yield np.frombuffer(raw, np.int16).astype(np.float32)
        ok = True
    finally:
        proc.stdout.close()
        rc = proc.wait()
        # a failed decode must raise like the one-shot path does, not
        # silently truncate the level stream (only when the generator ran
        # to completion - an abandoned generator shouldn't mask the
        # caller's own exception)
        if ok and rc != 0:
            raise subprocess.CalledProcessError(rc, cmd)


def probe_audio_rate(filename: str) -> int:
    """Native sample rate of a .wav (stdlib); non-wav decodes at 44100."""
    if filename.lower().endswith(".wav"):
        import wave
        with wave.open(filename, "rb") as w:
            return w.getframerate()
    return 44100


def resample_fft(x: np.ndarray, orig_sr: int, target_sr: float):
    """FFT resampling (scipy.signal.resample semantics) in jax.numpy."""
    import jax.numpy as jnp

    n = x.shape[-1]
    num = int(round(n * float(target_sr) / orig_sr))
    X = jnp.fft.rfft(jnp.asarray(x))
    n_out = num // 2 + 1
    if n_out <= X.shape[-1]:
        Xr = X[..., :n_out]
    else:
        Xr = jnp.concatenate(
            [X, jnp.zeros(X.shape[:-1] + (n_out - X.shape[-1],),
                          X.dtype)], axis=-1)
    y = jnp.fft.irfft(Xr, n=num) * (num / n)
    return y


@functools.lru_cache(None)
def _decimation_taps(ratio: int, per_branch: int = 48) -> np.ndarray:
    """Windowed-sinc lowpass for decimation by `ratio` (float32, odd length,
    DC gain 1, ~90dB stopband via Kaiser beta 8.6).  ratio 1 is the
    identity (source already at the target rate - e.g. the CLI's silent
    14.7kHz fallback track - must stream as a passthrough, not crash
    firwin with cutoff 1.0)."""
    if ratio == 1:
        return np.ones(1, np.float32)
    from scipy.signal import firwin

    taps = firwin(per_branch * ratio + 1, 1.0 / ratio,
                  window=("kaiser", 8.6))
    return taps.astype(np.float32)


class StreamingDecimator:
    """Exact-streaming integer-ratio FIR decimator.

    Output sample m is dot(h, x[m*ratio - half : m*ratio + half + 1]) with
    zero padding beyond the signal - each output is one independent dot
    product over a window, so results are bit-identical however the input
    is chunked (including one-shot).  feed() chunks, then flush() with the
    total length to emit the zero-padded tail; n_out = round(n / ratio)
    (scipy.signal.resample's output-length convention, which the FFT path
    and the reference's librosa resample share).
    """

    def __init__(self, ratio: int):
        self.ratio = int(ratio)
        self.h = _decimation_taps(self.ratio)
        self.half = (len(self.h) - 1) // 2
        # carried samples start at absolute index self.start
        self.carry = np.zeros(0, np.float32)
        self.start = 0
        self.next_m = 0

    def _emit(self, buf: np.ndarray, start: int, m_end: int) -> np.ndarray:
        """Outputs next_m..m_end-1 from buf (absolute start index `start`);
        callers guarantee the needed windows lie inside buf.

        The reduction runs tap-by-tap in a fixed sequential order (NOT a
        BLAS matmul, whose blocking - and therefore rounding - depends on
        the row count): each output element sees the exact same float ops
        under any chunking, making streamed output bit-identical."""
        n_out = m_end - self.next_m
        if n_out <= 0:
            return np.zeros(0, np.float32)
        first = self.next_m * self.ratio - self.half - start
        acc = np.zeros(n_out, np.float64)
        span = (n_out - 1) * self.ratio + 1
        for k in range(len(self.h)):
            acc += np.float64(self.h[k]) * buf[first + k:
                                               first + k + span:self.ratio]
        self.next_m = m_end
        return acc.astype(np.float32)

    def feed(self, chunk: np.ndarray) -> np.ndarray:
        """Consume a chunk; return the decimated samples now computable."""
        chunk = np.asarray(chunk, np.float32)
        if self.start == 0 and len(self.carry) == 0:
            # left edge: zero-pad so the first windows exist
            self.carry = np.zeros(self.half, np.float32)
            self.start = -self.half
        buf = np.concatenate([self.carry, chunk])
        end = self.start + len(buf)  # absolute end (exclusive)
        # last output whose window [m*r - half, m*r + half] fits fully
        m_end = (end - 1 - self.half) // self.ratio + 1
        out = self._emit(buf, self.start, m_end)
        # keep what future windows (from output next_m) still need
        keep_from = self.next_m * self.ratio - self.half
        drop = max(0, keep_from - self.start)
        self.carry = buf[drop:]
        self.start += drop
        return out

    def flush(self, n_total: int) -> np.ndarray:
        """Zero-pad the right edge and emit through n_out-1."""
        n_out = int(round(n_total / self.ratio))
        if n_out <= self.next_m:
            return np.zeros(0, np.float32)
        pad_to = (n_out - 1) * self.ratio + self.half + 1  # abs end needed
        buf = self.carry
        end = self.start + len(buf)
        if pad_to > end:
            buf = np.concatenate(
                [buf, np.zeros(pad_to - end, np.float32)])
        return self._emit(buf, self.start, n_out)


def resample_polyphase(x: np.ndarray, ratio: int) -> np.ndarray:
    """One-shot wrapper over StreamingDecimator (bit-identical to any
    chunked run of the same signal)."""
    d = StreamingDecimator(ratio)
    head = d.feed(np.asarray(x, np.float32))
    return np.concatenate([head, d.flush(len(x))])


class Audio:
    """Audio stream encoder.

    Accepts a filename or a raw (data, rate) pair.  `levels()` returns the
    int array of 5-bit speaker levels in -15..16, one per stream tick.
    """

    def __init__(self, filename: Optional[str] = None,
                 bitrate: int = 14700,
                 normalization: Optional[float] = None,
                 data: Optional[np.ndarray] = None,
                 rate: Optional[int] = None,
                 stream: Optional[bool] = None):
        """stream: force (True) or forbid (False) the bounded-memory
        streaming path; None picks it automatically for long inputs with
        an integral rate ratio.  Short inputs keep the one-shot FFT path
        bit-for-bit."""
        self.sample_rate = float(bitrate)
        self._filename = None
        if data is not None:
            self._data = np.asarray(data, dtype=np.float32)
            self._rate = int(rate or 44100)
            n_src = len(self._data)
        elif filename is not None:
            self._rate = probe_audio_rate(filename)
            n_src = self._source_length_estimate(filename)
            if self._decide_stream(stream, n_src):
                self._filename = filename
                self._data = None
            else:
                self._data, self._rate = decode_audio(filename)
                n_src = len(self._data)
        else:
            raise ValueError("need filename or data")
        self._streaming = self._decide_stream(stream, n_src)
        if stream and not self._streaming:
            raise ValueError(
                "stream=True needs an integral rate ratio (%s -> %s)"
                % (self._rate, self.sample_rate))
        self._resampled = None
        self._levels = None
        self.normalization = normalization or self._normalization()

    # --- streaming plumbing -------------------------------------------------

    def _ratio_int(self) -> Optional[int]:
        if self._rate == self.sample_rate:
            return 1
        r = self._rate / self.sample_rate
        return int(round(r)) if abs(r - round(r)) < 1e-9 and r > 1 else None

    def _decide_stream(self, stream: Optional[bool], n_src: int) -> bool:
        if self._ratio_int() is None:
            return False
        if stream is not None:
            return stream
        return n_src > STREAM_AUTO_SAMPLES

    @staticmethod
    def _source_length_estimate(filename: str) -> int:
        """Source sample count: exact for wav, size-derived otherwise
        (only feeds the stream-auto threshold, not any output shape)."""
        import os
        if filename.lower().endswith(".wav"):
            import wave
            try:
                with wave.open(filename, "rb") as w:
                    return w.getnframes()
            except Exception:
                pass
        # compressed containers: assume >=1:4 vs 16-bit mono 44.1k PCM
        return os.path.getsize(filename) * 2

    def _source_chunks(self) -> Iterator[np.ndarray]:
        if self._data is not None:
            for i in range(0, len(self._data), _STREAM_CHUNK):
                yield self._data[i:i + _STREAM_CHUNK]
            return
        yield from decode_audio_chunks(self._filename)

    def _resample(self) -> np.ndarray:
        if self._resampled is None:
            if self._streaming:
                raise RuntimeError(
                    "streaming Audio does not materialize the resampled "
                    "signal; use levels()")
            if self._rate == self.sample_rate:
                self._resampled = np.asarray(self._data, dtype=np.float32)
            else:
                self._resampled = np.asarray(
                    resample_fft(self._data, self._rate, self.sample_rate),
                    dtype=np.float32)
        return self._resampled

    def _normalization(self, read_bytes: int = 10 * 1024 * 1024):
        """Percentile normalization over the head of the resampled signal.

        The reference (audio.py:64-82) decodes the first ~10MB of the source
        and resamples *that head* before taking percentiles; match its head
        length by converting 10MB of mono int16 source bytes into the
        equivalent number of resampled samples.
        """
        n_src = read_bytes // 2  # mono int16 source samples
        max_samples = int(n_src * self.sample_rate / self._rate)
        if self._streaming:
            dec = StreamingDecimator(self._ratio_int())
            parts, got, fed = [], 0, 0
            for chunk in self._source_chunks():
                out = (chunk if dec.ratio == 1 else dec.feed(chunk))
                fed += len(chunk)
                parts.append(out)
                got += len(out)
                if got >= max_samples:
                    break
            if got < max_samples and dec.ratio != 1:
                parts.append(dec.flush(fed))
            a = np.concatenate(parts)[:max_samples] if parts else \
                np.zeros(1, np.float32)
        else:
            a = self._resample()[:max_samples]
        norm = np.max(np.abs(np.percentile(a, [0.5, 99.5])))
        if norm == 0:
            return 1.0
        return 16384.0 / norm

    def _levels_of(self, a: np.ndarray) -> np.ndarray:
        # int() truncation toward zero, then clip (reference audio.py:97-98)
        lv = np.trunc(a / 16384.0 * self.normalization * 16).astype(np.int32)
        return np.clip(lv, -15, 16)

    def levels(self) -> np.ndarray:
        """5-bit speaker levels, one per tick (reference audio.py:84-100).

        Streaming mode computes them chunk-by-chunk with bounded peak
        memory (the levels array itself is 4 bytes/tick - an hour is
        ~200MB of source but only ~13MB of levels)."""
        if self._levels is not None:
            return self._levels
        if not self._streaming:
            self._levels = self._levels_of(self._resample())
            return self._levels
        dec = StreamingDecimator(self._ratio_int())
        out, n_src = [], 0
        for chunk in self._source_chunks():
            n_src += len(chunk)
            a = chunk if dec.ratio == 1 else dec.feed(chunk)
            if len(a):
                out.append(self._levels_of(a))
        if dec.ratio != 1:
            tail = dec.flush(n_src)
            if len(tail):
                out.append(self._levels_of(tail))
        self._levels = np.concatenate(out) if out else \
            np.zeros(0, np.int32)
        return self._levels

    @property
    def n_ticks(self) -> int:
        if self._streaming:
            return len(self.levels())
        return len(self._resample())
