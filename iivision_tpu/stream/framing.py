"""2KB stream framing: ACK insertion, bank flip-flop, terminate padding.

The player drains its W5100 RX buffer in 2KB frames: each frame must end with
a 4-byte ACK opcode that advances the RX read pointer and (in DHGR mode) flips
the MAIN/AUX soft switch (player/main.s:1290-1344).  Byte-level parity with
reference transcoder/movie.py:113-161:

  - an ACK is emitted when stream_pos % 2048 reaches 2044 (ACK is 4 bytes, so
    every 2KB frame ends exactly on the boundary; the 7-byte header plus 291
    7-byte ticks hits 2044 in frame 0, and 292 ticks in every later frame);
  - in DHGR mode the active bank flips *before* the ACK is emitted, and the
    ACK byte (0x54/0x55) reflects the new bank;
  - the stream ends with a Terminate opcode zero-padded to the 2KB boundary.
"""

from typing import Iterable, Iterator, Optional

from iivision_tpu.stream import opcodes
from iivision_tpu.stream.opcodes import (
    Ack, Header, OpcodeAddresses, Terminate, emit_opcode)
from iivision_tpu.video_mode import VideoMode


class StreamFramer:
    """Stateful byte emitter enforcing the 2KB/ACK framing contract."""

    def __init__(self, video_mode: VideoMode,
                 addrs: Optional[OpcodeAddresses] = None,
                 max_bytes_out: Optional[int] = None):
        self.video_mode = video_mode
        self.addrs = addrs or opcodes.default_addresses()
        self.max_bytes_out = max_bytes_out or None
        self.stream_pos = 0
        self.aux_memory_bank = False  # current bank; segment 0 targets MAIN

    def _emit(self, op) -> bytes:
        b = emit_opcode(op, self.addrs)
        self.stream_pos += len(b)
        return b

    def emit_stream(self, ops: Iterable) -> Iterator[bytes]:
        """Yield stream byte chunks for an opcode iterator.

        `ops` yields Header/Tick opcodes; Acks and the final Terminate +
        padding are inserted here.  Consumers that need the bank flip to steer
        encoding (DHGR) should read `self.aux_memory_bank` between items,
        exactly as the reference's encode loop does via shared state
        (reference transcoder/movie.py:98-102).
        """
        for op in ops:
            if self.max_bytes_out and self.stream_pos >= self.max_bytes_out:
                yield from self.done()
                return
            yield self._emit(op)

            if self.stream_pos % 2048 >= 2044:
                if self.video_mode == VideoMode.DHGR:
                    self.aux_memory_bank = not self.aux_memory_bank
                yield self._emit(Ack(self.aux_memory_bank))
                assert self.stream_pos % 2048 == 0, self.stream_pos % 2048
        yield from self.done()

    def done(self) -> Iterator[bytes]:
        """Terminate opcode + zero padding to the 2KB frame boundary."""
        yield self._emit(Terminate())
        pad = 2048 - (self.stream_pos % 2048)
        self.stream_pos += pad
        yield bytes(pad)


def segment_schedule(total_ticks: int):
    """Partition a tick-opcode budget into 2KB stream segments.

    Returns a list of (n_ops, aux_bank_after_flip_DHGR) pairs - segment s has
    291 ops if s == 0 else 292, and in DHGR mode targets bank MAIN for even s,
    AUX for odd s.  Derived from the framing invariants above; used by the
    encoder to pre-plan a whole movie as one XLA program.
    """
    segs = []
    remaining = total_ticks
    s = 0
    while remaining > 0:
        cap = opcodes.OPS_FIRST_FRAME if s == 0 else opcodes.OPS_PER_FRAME
        n = min(cap, remaining)
        segs.append((n, s % 2 == 1))
        remaining -= n
        s += 1
    return segs
