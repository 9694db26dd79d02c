"""chip_smoke.py's phases at tiny sizes on the CPU.

On the card each phase runs at full size (python chip_smoke.py); here the
same functions run at tiny sizes so their control flow and checks are
exercised on every test run.  Only main() insists on a GPU.
"""

import json

import pytest

import chip_smoke

TINY = chip_smoke.Sizes(
    solo_seconds=1.0, solo_hw=(48, 64), cli_clips=2, cli_seconds=1.0,
    cli_hw=(48, 64), batch_movies=2, batch_seconds=1.0, batch_hw=(48, 64),
    yiq_tables=False, tablegen_rows=16, tablegen_samples=8,
    # the four-card checks run on 4 of the suite's 8 virtual CPU devices
    four_cards=chip_smoke.MeshSizes.tiny(4))
ALL_PHASES = dict(chip_smoke.PHASES + chip_smoke.FOUR_CARDS)


@pytest.mark.parametrize("name", list(ALL_PHASES))
def test_phase_at_tiny_size(name):
    rec = ALL_PHASES[name](TINY, seed=1)
    line = json.loads(chip_smoke.report(name, "test card", dict(rec)))
    assert line["phase"] == name and line["card"] == "test card"
    for key in ("compile_s", "warm_s", "peak_bytes_in_use", "realtime_x"):
        assert key in line
    if "warm_s" in rec and "movie_s" in rec:
        assert line["realtime_x"] > 0


def test_main_refuses_a_cpu_only_process(capsys):
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert out == ""  # no result line, no CPU fallback
    assert "needs an NVIDIA GPU" in err


def test_synth_clip_is_seeded():
    a = chip_smoke.synth_clip(3, 0.2, (8, 10))
    assert a.shape == (6, 8, 10, 3) and a.dtype.name == "uint8"
    assert (a == chip_smoke.synth_clip(3, 0.2, (8, 10))).all()
    assert (a != chip_smoke.synth_clip(4, 0.2, (8, 10))).any()
