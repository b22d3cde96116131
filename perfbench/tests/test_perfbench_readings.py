"""The readings script, on the CPU at a few hundred rows: one line per
set of right-hand sides and seed with the number compared; the control's
float32 answers read over the limit, the program's under it, and a seed
reorders its set while another set changes the answers."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import readings  # noqa: E402


def _read(**kw):
    return list(readings.read("hard-f64", seconds=0.01, device="cpu",
                              n=343, **kw))


def test_program_and_control_readings():
    prog = _read(seeds=[5, 6])
    assert [d["seed"] for d in prog] == [5, 6]
    assert all(d["failed"] == 0 and d["value"] <= d["limit"] for d in prog)
    assert prog[0]["value"] == prog[1]["value"]   # the same set, reordered
    ctl = _read(seeds=[5], dtype="float32")
    assert all(d["failed"] == d["judged"] for d in ctl)


def test_other_sets_of_right_hand_sides():
    lines = _read(seeds=[5, 6], rhs_seeds=(None, 3))
    assert [(d["rhs_seed"], d["seed"]) for d in lines] == [
        (0, 5), (0, 6), (3, 5), (3, 6)]
    assert lines[2]["value"] == lines[3]["value"]
    assert lines[0]["value"] != lines[2]["value"]
    assert all(d["failed"] == 0 for d in lines)


def test_the_command_reads_only_on_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    assert readings.main(["--workload", "hard-f64", "--seeds", "5",
                          "--seconds", "0.01"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_the_df32_control_fails_hard_f64_on_a_card():
    """The program's df32 path in hard-f64's place, at the cell's own
    size: its answers stop near 3e-13, over the float64 limit (at a few
    thousand rows df32 reaches 1e-13 and the two cannot be told apart,
    so this needs the card)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    (d,) = readings.read("hard-f64", [7], 0.0, dtype="df32")
    assert d["value"] > d["limit"] and d["failed"] >= 1
