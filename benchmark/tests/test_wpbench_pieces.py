"""The fast-stream cell's pieces a call (`stream_pieces`): its reader on
canned records, with and without the program's counter, on a card and on
the program's CPU path, and its entry."""

import pytest

from wpbench import cell

CELL = "fast-stream.wiki-en-10MB"
NAME = "stream_pieces"
WINDOW = {"calls": 30, "bytes": 300_000_000, "seconds": 3.0}
CARD = "NVIDIA H100 80GB HBM3"


def records(counters, window=WINDOW, device=CARD):
    return {"device": device, "window": window,
            "stages": {"encode": {"seconds": 0.3, "self_seconds": 0.01, "calls": 30},
                       "counters": counters},
            "trace": {"events": [], "calls": 2, "unit_bytes": 1}, "peaks": None}


def read(recs):
    return cell.Cell(CELL).reader(NAME)(recs)


@pytest.mark.parametrize("pieces,want", [(90, 3.0), (30, 1.0), (45, 1.5)],
                         ids=["three", "one", "mixed"])
def test_reader(pieces, want):
    c = {"stream_pieces": pieces, "stream_positions": 30 * 10_485_760, "stream_card_decoded_bytes": 1}
    assert read(records(c)) == pytest.approx(want)


@pytest.mark.parametrize("counters", [{"stream_positions": 30 * (3 << 22)}, {}, {"units_new": 5}],
                         ids=["one_program", "no_counters", "other_engine"])
def test_a_program_without_the_counter_reads_nothing(counters):
    """The parent of the pieces counts none."""
    assert read(records(counters)) is None


def test_an_empty_window_or_the_cpu_path_reads_nothing():
    assert read(records({"stream_pieces": 0}, dict(WINDOW, calls=0, bytes=0))) is None
    assert read(records({"stream_pieces": 30}, device="cpu")) is None


def test_the_entry():
    entry = [m for m in cell.Cell(CELL).per_layer if m["name"] == NAME]
    assert entry and entry[0]["workloads"] == [CELL]
    assert (entry[0]["moves"], entry[0]["layer"], entry[0]["better"], entry[0]["unit"]) == (
        "device_memory_peak_MB", "device dispatch", "lower", "pieces/call")
