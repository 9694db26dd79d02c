"""Stream ABI tests: symbol table, opcode byte emission, 2KB framing."""

import io

import pytest

from iivision_tpu.stream import framing, opcodes
from iivision_tpu.stream.opcodes import (
    Ack, Header, Nop, Terminate, Tick, audio_level_to_tick, emit_opcode)
from iivision_tpu.stream.symbols import SymbolTable
from iivision_tpu.video_mode import VideoMode

FAKE_DBG = """version	major=2,minor=0
info	csym=0,file=3,lib=0,line=737,mod=1,scope=0,seg=8,span=472,sym=6,type=0
sym	id=0,name="op_ack",addrsize=absolute,scope=1,def=720,val=0xBA72,seg=0,type=lab
sym	id=1,name="op_terminate",addrsize=absolute,val=0xBA64,type=lab
sym	id=2,name="other_symbol",addrsize=absolute,val=0x1234,type=lab
"""


def test_symbol_table_parse_stream():
    syms = SymbolTable().parse(io.StringIO(FAKE_DBG))
    assert syms['"op_ack"']["val"] == "0xBA72"
    assert syms['"op_terminate"']["val"] == "0xBA64"
    assert syms['"other_symbol"']["val"] == "0x1234"


def test_vendored_dbg_opcode_addresses():
    # Frozen ABI values from the checked-in player build artifact
    addrs = opcodes.default_addresses()
    assert addrs.ack == 0xBA72
    assert addrs.terminate == 0xBA64
    assert addrs.nop == 0x4070
    assert addrs.header == 0x215B
    assert addrs.tick[(66, 63)] == 0xBA30
    assert len(addrs.tick) == 1024
    # Tick opcode bodies are 52 bytes apart within a page group in the player
    assert addrs.tick[(64, 63)] == 0xB9FC


def test_emit_header():
    b = emit_opcode(Header(VideoMode.DHGR))
    assert b == bytes([0xFF] * 6 + [1])
    assert emit_opcode(Header(VideoMode.HGR))[-1] == 0


def test_emit_tick():
    addrs = opcodes.default_addresses()
    a = addrs.tick[(34, 40)]
    b = emit_opcode(Tick(34, 40, content=0x7F, offsets=(1, 2, 3, 4)))
    assert b == bytes([a >> 8, a & 0xFF, 0x7F, 1, 2, 3, 4])
    assert len(b) == opcodes.TICK_BYTES


def test_emit_ack_terminate_nop():
    assert emit_opcode(Ack(False)) == bytes([0xBA, 0x72, 0x54, 0xFF])
    assert emit_opcode(Ack(True)) == bytes([0xBA, 0x72, 0x55, 0xFF])
    assert emit_opcode(Terminate()) == bytes([0xBA, 0x64])
    assert emit_opcode(Nop()) == bytes([0x40, 0x70])


def test_tick_requires_4_offsets():
    with pytest.raises(ValueError):
        Tick(34, 40, 0, (1, 2, 3))


def test_audio_level_to_tick():
    assert audio_level_to_tick(-15) == 4
    assert audio_level_to_tick(0) == 34
    assert audio_level_to_tick(16) == 66


def _tick_stream(n):
    yield Header(VideoMode.DHGR)
    for i in range(n):
        yield Tick(34, 32 + (i % 32), content=i % 128, offsets=(0, 1, 2, 3))


def collect(framer, ops):
    return b"".join(framer.emit_stream(ops))


def test_framing_ack_positions_and_padding():
    framer = framing.StreamFramer(VideoMode.DHGR)
    out = collect(framer, _tick_stream(291 + 292 + 50))
    # total stream is a whole number of 2KB frames
    assert len(out) % 2048 == 0
    assert len(out) == 3 * 2048
    # frame 0: header + 291 ticks = 2044 bytes, then ACK (flip to AUX = 0x55)
    assert out[2044:2048] == bytes([0xBA, 0x72, 0x55, 0xFF])
    # frame 1: 292 ticks then ACK back to MAIN
    assert out[4092:4096] == bytes([0xBA, 0x72, 0x54, 0xFF])
    # terminate opcode directly follows the last tick
    term_pos = 2 * 2048 + 50 * 7
    assert out[term_pos:term_pos + 2] == bytes([0xBA, 0x64])
    # zero padding to the end
    assert set(out[term_pos + 2:]) == {0}


def test_framing_hgr_ack_never_flips():
    framer = framing.StreamFramer(VideoMode.HGR)
    out = collect(framer, _tick_stream(291 + 292 * 2))
    for fr in range(3):
        ack = out[(fr + 1) * 2048 - 4:(fr + 1) * 2048]
        assert ack == bytes([0xBA, 0x72, 0x54, 0xFF])
    assert not framer.aux_memory_bank


def test_framing_bank_flip_visible_between_ops():
    """DHGR bank state flips before the ACK and is visible to the opcode
    producer on the next pull (reference transcoder/movie.py:98-148)."""
    framer = framing.StreamFramer(VideoMode.DHGR)
    seen_banks = []

    def ops():
        yield Header(VideoMode.DHGR)
        for i in range(292 * 2):
            seen_banks.append(framer.aux_memory_bank)
            yield Tick(34, 32, 0, (0, 0, 0, 0))

    _ = collect(framer, ops())
    # first 291 ticks see MAIN, then AUX for the next 292
    assert seen_banks[0] is False
    assert seen_banks[290] is False
    assert seen_banks[291] is True
    assert seen_banks[291 + 291] is True
    assert seen_banks[291 + 292] is False


def test_framing_max_bytes_out():
    framer = framing.StreamFramer(VideoMode.HGR, max_bytes_out=3000)
    out = collect(framer, _tick_stream(10000))
    assert len(out) % 2048 == 0
    assert len(out) <= 4096


def test_segment_schedule():
    segs = framing.segment_schedule(291 + 292 + 100)
    assert segs == [(291, False), (292, True), (100, False)]
    assert framing.segment_schedule(5) == [(5, False)]


def test_golden_stream_hash():
    """End-to-end ABI lock: a pinned movie encoded with seed=None emits a
    byte stream whose hash is frozen - across backends too (the encoder's
    value-carrying matmuls run at HIGHEST precision; chip_smoke.py and
    tests/test_gpu.py check the same hash on a GPU)."""
    import hashlib

    import numpy as np

    from iivision_tpu import encoder
    from iivision_tpu.ops import distance
    from iivision_tpu.palettes import Palette
    from iivision_tpu.stream.emit_fast import emit_stream_fast
    from iivision_tpu.video_mode import VideoMode

    mode = VideoMode.DHGR
    dist = distance.ComputedDistance(mode, Palette.NTSC)
    rng = np.random.RandomState(123)
    fmain = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, 0x80, size=(2, 32, 256)).astype(np.uint8)
    plan, _ = encoder.plan_movie(
        n_frames=2, n_audio_ticks=1200, input_frame_rate=12.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
    lanes, bytes_ = encoder.prepare_targets(fmain, faux, mode)
    ops, _, _ = encoder.encode_movie(dist, lanes, bytes_, plan, mode,
                                     seed=None)
    flat = encoder.flatten_ops(np.asarray(ops), plan)
    levels = ((np.arange(plan.n_ops) % 32) - 15).astype(np.int32)
    data = emit_stream_fast(flat, levels, mode)
    assert len(data) == 10240
    assert hashlib.sha256(data).hexdigest() == (
        "57fdd52adf53d75101ed121d28d8a5389465c09f99d960ba6c47c20dbdb30fbc")
