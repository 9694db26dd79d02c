"""Native player-VM tests: stream decode, framing validation, screen
reconstruction, and end-to-end encoder -> stream -> VM parity."""

import numpy as np
import pytest

from iivision_tpu import encoder, screen
from iivision_tpu.sim import PlayerVM
from iivision_tpu.stream.framing import StreamFramer
from iivision_tpu.stream.opcodes import Header, Tick, audio_level_to_tick
from iivision_tpu.video_mode import VideoMode


@pytest.fixture(scope="module")
def vm():
    return PlayerVM()


def build_stream(mode, ticks):
    framer = StreamFramer(mode)

    def ops():
        yield Header(mode)
        yield from ticks
    return b"".join(framer.emit_stream(ops()))


def test_decode_simple_stream(vm):
    ticks = [Tick(34, 32 + (i % 32), i % 128, (i % 256, 1, 2, 3))
             for i in range(600)]
    stream = build_stream(VideoMode.HGR, ticks)
    res = vm.decode(stream)
    assert res.ok, (res.error, res.error_pos)
    assert res.n_ops == 600
    assert res.n_acks == 2  # ops 291 + 292 covered, remainder unseen
    assert res.video_mode == 0
    assert res.cycles == 600 * 73 + 2 * 146
    assert np.all(res.duty == 34)
    # last store of page 32+i%32 etc: spot-check one store
    # op 0: page 32, content 0, offsets (0,1,2,3)
    # later ops overwrite; verify via replay
    mem = np.zeros((32, 256), np.uint8)
    for t in ticks:
        for o in t.offsets:
            mem[t.page - 32, o] = t.content
    assert np.array_equal(res.main, mem)


def test_decode_dhgr_bank_switching(vm):
    ticks = [Tick(4 + 2 * (i % 32), 32, 7, (i % 256, 0, 0, 0))
             for i in range(291 + 292)]
    stream = build_stream(VideoMode.DHGR, ticks)
    res = vm.decode(stream)
    assert res.ok, res.error
    assert res.video_mode == 1
    # first 291 ops hit MAIN, next 292 hit AUX
    mem_m = np.zeros((32, 256), np.uint8)
    mem_a = np.zeros((32, 256), np.uint8)
    for i, t in enumerate(ticks):
        mem = mem_m if i < 291 else mem_a
        for o in t.offsets:
            mem[t.page - 32, o] = t.content
    assert np.array_equal(res.main, mem_m)
    assert np.array_equal(res.aux, mem_a)
    assert res.duty[0] == 4
    assert res.duty[31] == 66


def test_decode_rejects_corruption(vm):
    ticks = [Tick(34, 32, 1, (0, 0, 0, 0)) for _ in range(400)]
    stream = bytearray(build_stream(VideoMode.HGR, ticks))

    # corrupt header
    bad = bytearray(stream)
    bad[0] = 0x00
    assert vm.decode(bytes(bad)).error == "ERR_HEADER"

    # unknown opcode address
    bad = bytearray(stream)
    bad[7] = 0x12
    bad[8] = 0x34
    assert vm.decode(bytes(bad)).error == "ERR_UNKNOWN_OPCODE"

    # corrupt the ACK soft-switch byte
    bad = bytearray(stream)
    assert bad[2044:2046] == bytes([0xBA, 0x72])
    bad[2046] = 0x99
    assert vm.decode(bytes(bad)).error == "ERR_ACK_BYTE"

    # nonzero padding after terminate
    bad = bytearray(stream)
    bad[-1] = 1
    assert vm.decode(bytes(bad)).error == "ERR_PADDING"

    # non-2KB stream length
    assert vm.decode(bytes(stream[:-7])).error == "ERR_STREAM_LENGTH"

    # truncation without terminate (whole frames but no terminate)
    ticks2 = [Tick(34, 32, 1, (0, 0, 0, 0)) for _ in range(291)]
    framer = StreamFramer(VideoMode.HGR)
    chunks = []
    gen = framer.emit_stream(
        iter([Header(VideoMode.HGR)] + ticks2))
    full = b"".join(gen)
    assert vm.decode(full[:2048]).error == "ERR_NOT_TERMINATED"


def test_encoder_to_vm_end_to_end(vm):
    """Full pipeline: device-encoder ops -> framed stream -> player VM; the VM's
    final screen memory must equal the encoder's own model."""
    from tests.test_encoder import get_dist

    mode = VideoMode.DHGR
    dist = get_dist(mode)
    rng = np.random.RandomState(11)
    F = 2
    fmain = rng.randint(0, 0x80, size=(F, 32, 256)).astype(np.uint8)
    faux = rng.randint(0, 0x80, size=(F, 32, 256)).astype(np.uint8)

    plan, n_enc = encoder.plan_movie(
        n_frames=F, n_audio_ticks=1500, input_frame_rate=14.0,
        ticks_per_second=14700.0, every_n_video_frames=1, mode=mode, k=8)
    lanes_tgt, bytes_tgt = encoder.prepare_targets(fmain, faux, mode)
    ops_dev, fin_main, fin_aux = encoder.encode_movie(
        dist, lanes_tgt, bytes_tgt, plan, mode, seed=7)
    flat = encoder.flatten_ops(np.asarray(ops_dev), plan)

    levels = rng.randint(-15, 17, size=plan.n_ops)
    framer = StreamFramer(mode)

    def op_iter():
        yield Header(mode)
        yield from encoder.ops_to_ticks(flat, levels)

    stream = b"".join(framer.emit_stream(op_iter()))
    res = vm.decode(stream)
    assert res.ok, (res.error, res.error_pos)
    assert res.n_ops == plan.n_ops

    # audio duty parity
    assert np.array_equal(
        res.duty, np.array([audio_level_to_tick(a) for a in levels]))

    # Screen-memory parity between player and encoder model, everywhere
    # except positions touched only by padding ops (the encoder model does
    # not apply padding stores, mirroring reference video.py:248-251).
    fin_main = np.asarray(fin_main)
    fin_aux = np.asarray(fin_aux)
    pad_mask = np.zeros((2, 32, 256), bool)
    pad = (flat[:, 0] == 32) & (flat[:, 2:] == 0).all(axis=1)
    # padding ops store target[0,0] at (0,0): exclude that cell per bank
    # (bank of op i known from plan)
    op_bank = np.repeat(np.asarray([b for b in _op_banks(plan)]), 1)
    for i in np.flatnonzero(pad):
        pad_mask[op_bank[i], 0, 0] = True

    vm_banks = np.stack([res.main, res.aux])
    enc_banks = np.stack([fin_main.astype(np.uint8),
                          fin_aux.astype(np.uint8)])
    eq = (vm_banks == enc_banks) | pad_mask[:, :, :]
    assert eq.all(), np.argwhere(~eq)[:5]


def _op_banks(plan):
    """Bank of each emitted opcode, reconstructed from the step schedule."""
    banks = []
    for s in range(len(plan.step_frame)):
        banks.extend([int(plan.step_bank[s])] * int(plan.step_nvalid[s]))
    return banks
