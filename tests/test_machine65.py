"""6502 machine-level verification: assembler vs .dbg, player execution.

The strongest parity evidence in the repo: the REAL player program
(assembled from the vendored source, every label validated against the
frozen cc65 .dbg) executes an emitted `.a2m` stream instruction by
instruction on a simulated Apple IIe + W5100, and must reproduce the
encoder's screen model with cycle-exact speaker timing.
"""

import numpy as np
import pytest

from iivision_tpu.sim import asm65, machine65
from iivision_tpu.sim.player_vm import PlayerVM
from iivision_tpu.stream import opcodes as ops_mod
from iivision_tpu.stream.framing import StreamFramer
from iivision_tpu.stream.opcodes import Header, Tick
from iivision_tpu.video_mode import VideoMode


# --- assembler ----------------------------------------------------------------

def test_assembler_matches_dbg():
    asm = asm65.assemble_player()
    compared = asm65.validate_against_dbg(asm)
    assert len(compared) > 1900
    want = asm65.dbg_labels(
        "iivision_tpu/data/iivision.dbg")
    ops = [n for n in want if n.startswith("op_")]
    assert len(ops) == 1028  # 1024 ticks + header/nop/ack/terminate
    for n in ops:
        assert asm.symbols[n] == want[n], n


def test_assembler_expression_and_modes():
    src = """
base = $1234
zp = $08
    .segment "CODE"
start:
    LDA #<base
    LDX #>base
    STA zp
    STA base
    STA base,X
    STA $2000,Y
loop:
    BNE loop
    JMP (base)
    .byte 1, 2, $FF
    .word base
"""
    asm = asm65.Assembler({"CODE": 0x4000}).assemble(src)
    img = asm.image
    assert asm.symbols["start"] == 0x4000
    assert img[0x4000:0x4002] == bytes([0xA9, 0x34])  # LDA #$34
    assert img[0x4002:0x4004] == bytes([0xA2, 0x12])  # LDX #$12
    assert img[0x4004:0x4006] == bytes([0x85, 0x08])  # STA zp
    assert img[0x4006:0x4009] == bytes([0x8D, 0x34, 0x12])
    assert img[0x4009:0x400C] == bytes([0x9D, 0x34, 0x12])
    assert img[0x400C:0x400F] == bytes([0x99, 0x00, 0x20])
    assert img[0x400F:0x4011] == bytes([0xD0, 0xFE])  # BNE -2
    assert img[0x4011:0x4014] == bytes([0x6C, 0x34, 0x12])
    assert img[0x4014:0x4017] == bytes([1, 2, 0xFF])
    assert img[0x4017:0x4019] == bytes([0x34, 0x12])


def test_assembler_macro_ident_concat():
    src = """
    .macro mk name, val
.ident(.concat("lab_", .string(val))):
    LDA #val
.endmacro
    .segment "CODE"
mk foo, 7
mk foo, 9
"""
    asm = asm65.Assembler({"CODE": 0x5000}).assemble(src)
    assert asm.symbols["lab_7"] == 0x5000
    assert asm.symbols["lab_9"] == 0x5002


# --- streams ------------------------------------------------------------------

def synth_stream(n_ops=600, mode=VideoMode.DHGR, seed=0):
    f = StreamFramer(mode)
    rng = np.random.RandomState(seed)
    ops = [Header(mode)]
    duties = []
    hi = 128 if mode == VideoMode.DHGR else 256
    for i in range(n_ops):
        duty = 4 + 2 * int(rng.randint(0, 32))
        page = 32 + int(rng.randint(0, 32))
        content = int(rng.randint(0, hi))
        offs = tuple(int(x) for x in rng.randint(0, 256, 4))
        ops.append(Tick(duty, page, content, offs))
        duties.append(duty)
    return b"".join(f.emit_stream(iter(ops))), np.asarray(duties)


def split_slow_path_pairs(duty_pairs, n_ops):
    """Separate the machine's tick pairs into data-op duties and slow-path
    (recv/ACK) duties using the framing schedule: 1 initial recv pair, then
    2 ACK pairs after each 2KB frame of 291 (first) / 292 ops."""
    data, slow = [], [list(duty_pairs[:1])]
    i = 1
    remaining = n_ops
    per_frame = ops_mod.OPS_FIRST_FRAME
    while remaining > 0:
        take = min(per_frame, remaining)
        data.extend(duty_pairs[i:i + take])
        i += take
        remaining -= take
        if remaining > 0:
            slow.append(list(duty_pairs[i:i + 2]))
            i += 2
        per_frame = ops_mod.OPS_PER_FRAME
    return np.asarray(data), slow


def expected_hardware_duty(duties):
    """Nominal duty -> actual hardware duty.

    The reference documents that 2 of the 32 duty variants are off by one
    cycle "because I couldn't find a way to exactly reproduce the target
    cycle count" (reference README.md:156) without naming them; executing
    the assembled opcodes identifies the pair: op_tick_22 ticks 21 cycles
    apart and op_tick_40 ticks 39 (both still total exactly 73).  The
    instruction sums in main.s:681-692 and :838-854 confirm it: 4+4+4+5+4
    = 21 and 4+4+4+5+4+5+4+5+4 = 39 cycles between the two STA TICKs.
    """
    d = np.asarray(duties).copy()
    d[d == 22] = 21
    d[d == 40] = 39
    return d


@pytest.mark.parametrize("mode", [VideoMode.DHGR, VideoMode.HGR])
def test_player_executes_stream_screen_parity(mode):
    data, duties = synth_stream(650, mode)
    res = machine65.play_stream(data)
    assert res.exit_reason == "TERMINATED", res
    vm = PlayerVM().decode(data)
    assert vm.ok, vm.error
    assert np.array_equal(res.main, vm.main)
    if mode == VideoMode.DHGR:
        assert np.array_equal(res.aux, vm.aux)
    else:
        assert res.aux.sum() == 0  # HGR never touches aux
    # every 2KB frame issued one W5100 RECV
    assert res.n_recv == vm.n_acks
    # X=0 invariant held through the final dispatch
    assert res.regs[1] == 0


def test_player_pause_resume_key():
    """The player's documented pause feature (reference README.md v0.2
    "Press any key to pause/resume"; main.s recv keyboard check): a key
    latched at the 2KB recv boundary makes the player spin on KBD until a
    second key, then playback continues to TERMINATED with the SAME final
    screens - only wall cycles grow by (roughly) the pause length."""
    data, _ = synth_stream(650)
    base = machine65.play_stream(data)
    assert base.exit_reason == "TERMINATED"

    pause_at = base.cycles // 2
    resume_after = 250_000
    res = machine65.play_stream(
        data, key_events=[(pause_at, ord(" ")),
                          (pause_at + resume_after, ord(" "))])
    assert res.exit_reason == "TERMINATED", res
    assert np.array_equal(res.main, base.main)
    assert np.array_equal(res.aux, base.aux)
    assert res.n_recv == base.n_recv
    # the pause spin burns (at least) the gap between the two keys, minus
    # the cycles until the next recv boundary where KBD is first read
    assert res.cycles >= base.cycles + resume_after - 75_000, \
        (res.cycles, base.cycles)
    # and not wildly more: the spin ends at the second key (+ slack for
    # reaching the next 2KB boundary before the pause begins)
    assert res.cycles <= base.cycles + resume_after + 150_000


def test_player_terminate_key_and_prodos_quit():
    """With the op_terminate entry trap removed, the player's REAL ending
    executes: op_terminate waits for a keypress, then exits via the
    ProDOS MLI QUIT call (main.s op_terminate/exit)."""
    data, _ = synth_stream(650)
    base = machine65.play_stream(data)

    key_at = base.cycles + 80_000
    player = machine65.Apple2Player()
    res = player.run(data, key_events=[(key_at, 0x1B)],
                     terminate_trap=False)
    assert res.exit_reason == "PRODOS_QUIT", res
    assert np.array_equal(res.main, base.main)
    assert np.array_equal(res.aux, base.aux)
    # it spun in op_terminate's key-wait until the scheduled keypress
    assert res.cycles >= key_at


def test_player_connect_retry_and_failure():
    """The player's failure handling (reference main.s CHECKTEST/FAILED:
    6-attempt connect retry with full W5100 re-reset, then BRK with an
    error message via COUT - SURVEY 5.3): injected CONNECT failures drive
    the REAL retry loop, and the error path prints the real string."""
    data, _ = synth_stream(650)

    # two failures then success: a '.' per retry, playback completes
    res = machine65.play_stream(data, connect_fails=2)
    assert res.exit_reason == "TERMINATED", res
    assert res.cout.count(b"\xae") == 2  # "." in Apple high-ASCII

    # permanent failure: all 6 attempts exhausted -> BRK + error string
    res = machine65.play_stream(data, connect_fails=99)
    assert res.exit_reason == "BRK", res
    text = bytes(b & 0x7F for b in res.cout).decode("ascii")
    assert "SOCKET COULD NOT CONNECT" in text, text
    assert text.count(".") == 5  # 6 attempts = 5 retry dots before BRK


def test_player_cycle_accounting():
    """Every data opcode must take exactly 73 cycles with its encoded duty,
    and the ACK slow path exactly 2x73 with the 36/37 tick cadence
    (main.s:366-398) - checked by execution, not by comment."""
    n_ops = 650
    data, duties = synth_stream(n_ops)
    res = machine65.play_stream(data)
    pairs = res.duty_cycles
    starts = res.tick_cycles[0::2]

    data_duty, slow = split_slow_path_pairs(pairs, n_ops)
    assert len(data_duty) == n_ops
    assert np.array_equal(data_duty, expected_hardware_duty(duties))

    # data ops tick exactly 73 cycles apart (within each 2KB frame)
    data_starts, _ = split_slow_path_pairs(starts, n_ops)
    per_frame = ops_mod.OPS_FIRST_FRAME
    i = 0
    while i < n_ops:
        take = min(per_frame, n_ops - i)
        gaps = np.diff(data_starts[i:i + take])
        assert np.all(gaps == 73), (i, np.unique(gaps))
        i += take
        per_frame = ops_mod.OPS_PER_FRAME

    # ACK slow path: 2 tick pairs at the 36/37-cycle neutral cadence
    for ack_pair in slow[1:]:
        assert len(ack_pair) == 2
        assert 30 <= ack_pair[0] <= 40, ack_pair


def test_movie_end_to_end_on_machine(tmp_path):
    """Full pipeline: device encoder -> .a2m -> real player executing on the
    simulated Apple IIe -> screen memory equals the encoder's model."""
    from iivision_tpu import audio as audio_mod
    from iivision_tpu.movie import Movie
    from iivision_tpu.palettes import Palette
    from tests.test_encoder import get_dist
    from tests.test_pipeline import gradient_movie

    mode = VideoMode.DHGR
    rgb = gradient_movie(F=4)
    tone = (np.sin(2 * np.pi * 330 * np.arange(4410) / 4410) * 16000)
    m = Movie(
        frames_source=rgb,
        audio_source=audio_mod.Audio(data=tone.astype(np.float32),
                                     rate=14700, bitrate=14700),
        every_n_video_frames=2, video_mode=mode, palette=Palette.NTSC,
        k=8, dist=get_dist(mode))
    out = str(tmp_path / "m.a2m")
    m.transcode(out)
    data = open(out, "rb").read()

    res = machine65.play_stream(data)
    assert res.exit_reason == "TERMINATED"
    fin_m = m.final_main.astype(np.uint8)
    fin_a = m.final_aux.astype(np.uint8)
    eqm = res.main == fin_m
    eqa = res.aux == fin_a
    eqm[0, 0] = eqa[0, 0] = True  # padding cell (not applied by the model)
    assert eqm.all(), np.argwhere(~eqm)[:5]
    assert eqa.all(), np.argwhere(~eqa)[:5]

    # duty cycles reproduce the audio levels
    n_ops = m.plan.n_ops
    data_duty, _ = split_slow_path_pairs(res.duty_cycles, n_ops)
    lv = np.asarray(m.audio.levels())[:n_ops]
    assert np.array_equal(data_duty, expected_hardware_duty(lv * 2 + 34))


def test_verify_stream_cli(tmp_path, capsys):
    """The verification CLI passes a valid stream (incl. 6502 execution)
    and fails a corrupted one."""
    from iivision_tpu import verify_stream

    data, _ = synth_stream(650, VideoMode.DHGR)
    path = str(tmp_path / "ok.a2m")
    open(path, "wb").write(data)
    assert verify_stream.main([path, "--machine"]) == 0
    out = capsys.readouterr().out
    assert "6502 screen memory matches" in out

    bad = bytearray(data)
    bad[2044] ^= 0xFF  # corrupt the first ACK's opcode address
    badp = str(tmp_path / "bad.a2m")
    open(badp, "wb").write(bytes(bad))
    assert verify_stream.main([badp]) == 1


def test_asm65_rejects_bad_input():
    src_dup = """
    .segment "CODE"
a = 1
a = 2
"""
    with pytest.raises(asm65.AsmError, match="redefinition"):
        asm65.Assembler({"CODE": 0x4000}).assemble(src_dup)

    with pytest.raises(asm65.AsmError, match="unknown instruction"):
        asm65.Assembler({"CODE": 0x4000}).assemble(
            '    .segment "CODE"\n    FOO #1\n')

    with pytest.raises(asm65.AsmError, match="branch out of range"):
        asm65.Assembler({"CODE": 0x4000}).assemble(
            '    .segment "CODE"\nfar = $8000\n    BNE far\n')


# --- CPU instruction-set coverage, exit codes, tracing ------------------------


def test_65c02_forms_execute():
    """Every 65C02 form asm65 advertises (BRA, PHX/PHY/PLX/PLY, STZ) must
    execute on the machine, not just assemble."""
    res = machine65.run_program("""
    .segment "CODE"
start:
    LDX #$21
    LDY #$42
    PHX
    PHY
    LDX #0
    LDY #0
    PLY             ; Y = pushed Y ($42)
    PLX             ; X = pushed X ($21)
    LDA #$FF
    STA $40
    STA $44
    STA $2100
    STA $2104
    STZ $40         ; STZ zp
    STZ $2100       ; STZ abs
    LDX #4
    STZ $40,X       ; STZ zp,X
    STZ $2100,X     ; STZ abs,X
    LDX #$21
    BRA over        ; 65C02 unconditional branch
    BRK             ; must be skipped
over:
    LDA #$A5
stop:
    NOP
""")
    assert res.exit_reason == "TERMINATED", res.exit_reason
    a, x, y = res.regs
    assert (a, x, y) == (0xA5, 0x21, 0x42)
    assert res.memory[0x40] == 0 and res.memory[0x44] == 0
    assert res.memory[0x2100] == 0 and res.memory[0x2104] == 0


def test_nmos_rmw_and_indexed_forms():
    """Memory shifts, indexed inc/dec, indirect logic ops, RTI."""
    res = machine65.run_program("""
ptr = $60
    .segment "CODE"
start:
    LDA #$81
    STA $50
    ASL $50         ; $02, C=1
    ROL $50         ; $05 (carry in)
    LDA #$41
    STA $5000
    ROR $5000       ; C=1 from ROL's carry-out 0 -> no: C=0 -> $20
    LSR $5000       ; $10
    LDX #3
    INC $5100,X
    INC $5100,X
    DEC $5104,X
    ; (zp),Y logic
    LDA #$00
    STA ptr
    LDA #$52
    STA ptr+1
    LDY #7
    LDA #$0F
    STA $5207
    LDA #$F0
    ORA (ptr),Y     ; A = $FF
    STA $51
    ; RTI: push target then status; must land exactly at `ret`
    LDA #>ret
    PHA
    LDA #<ret
    PHA
    PHP
    RTI
    BRK
ret:
    LDA $50
stop:
    NOP
""")
    assert res.exit_reason == "TERMINATED", res.exit_reason
    assert res.memory[0x50] == 0x05
    assert res.regs[0] == 0x05  # LDA $50 at ret
    assert res.memory[0x5000] == 0x10
    assert res.memory[0x5103] == 2
    assert res.memory[0x5107] == 0xFF
    assert res.memory[0x51] == 0xFF


def test_brk_vs_undocumented_exit_codes():
    """A corrupt stream steering into data (undocumented opcode) must be
    distinguishable from an explicit BRK error stop."""
    res_brk = machine65.run_program("""
    .segment "CODE"
start:
    NOP
    BRK
stop:
    NOP
""")
    assert res_brk.exit_reason == "BRK"
    assert res_brk.pc == res_brk.symbols["start"] + 1

    res_ill = machine65.run_program("""
    .segment "CODE"
start:
    NOP
    .byte $02       ; JAM (undocumented)
stop:
    NOP
""")
    assert res_ill.exit_reason == "UNDOCUMENTED"
    assert res_ill.pc == res_ill.symbols["start"] + 1


def test_trace_first_and_ring():
    """Instruction tracing: first-N and last-N (ring) capture with
    register state and disassembly (incl. symbol rendering)."""
    src = """
    .segment "CODE"
start:
    LDA #$17
    LDX #$02
    NOP
    NOP
    NOP
    JMP finish
finish:
    NOP
stop:
    NOP
"""
    res = machine65.run_program(src, trace=("first", 3))
    assert res.n_executed == 7
    assert len(res.trace) == 3
    t0, t1, t2 = res.trace
    assert t0.pc == res.symbols["start"]
    assert t0.disassemble() == "LDA #$17"
    assert t1.disassemble() == "LDX #$02"
    assert (t1.a, t1.x) == (0x17, 0)   # state BEFORE the instruction
    assert (t2.a, t2.x) == (0x17, 2)
    assert t2.cycles == 4  # LDA(2) + LDX(2)

    res = machine65.run_program(src, trace=("ring", 2))
    assert res.n_executed == 7
    assert len(res.trace) == 2
    assert res.trace[0].disassemble(res.symbols) == "JMP finish"
    assert res.trace[1].pc == res.symbols["finish"]
    assert res.trace[1].disassemble() == "NOP"
    assert "JMP" in res.trace[0].format(res.symbols)


def test_play_stream_trace_locates_instruction():
    """Tracing through the real player: the ring trace's tail must be the
    op_terminate dispatch path."""
    data, _ = synth_stream(5, VideoMode.DHGR)
    res = machine65.play_stream(data, trace=("ring", 8))
    assert res.exit_reason == "TERMINATED"
    assert len(res.trace) == 8
    syms = machine65._PLAYER.assembly.symbols
    # the last traced instruction is the JMP dispatch into op_terminate
    assert res.trace[-1].disassemble(syms).startswith("JMP")
