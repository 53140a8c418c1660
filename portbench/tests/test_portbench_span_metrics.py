"""The readers of the program's own spans and counters in the window's
run_report.json: what they read, nothing where the report has nothing
(a zero, or a program without the spans), and a traced tiny run on the
CPU that carries all three."""
import pytest

from portbench import run

NAMES = [("loop.write_ms_per_block", "ms"),
         ("loop.assemble_ms_per_block", "ms"), ("embed.crop_fill", "%")]


def ctx(**report):
    r = {"blocks": 10, "consume_write_seconds": 2.5,
         "consume_assemble_seconds": 0.4, "embed_crops": 150,
         "embed_slots": 192}
    r.update(report)
    return {"report": r}


def test_readers_read_the_report():
    got = run.layer_metrics(NAMES, ctx())
    assert got["loop.write_ms_per_block"] == {"value": pytest.approx(250),
                                              "unit": "ms"}
    assert got["loop.assemble_ms_per_block"]["value"] == pytest.approx(40)
    assert got["embed.crop_fill"] == {"value": pytest.approx(78.125),
                                      "unit": "%"}


@pytest.mark.parametrize("report, left", [
    ({"blocks": 0}, {"embed.crop_fill"}),
    ({"embed_slots": 0, "embed_crops": 0},
     {"loop.write_ms_per_block", "loop.assemble_ms_per_block"}),
])
def test_a_zero_gives_no_metric(report, left):
    assert set(run.layer_metrics(NAMES, ctx(**report))) == left


def test_a_program_without_the_spans_gives_none():
    """The parent's report: the seven phases, no children, no
    counters."""
    old = {"blocks": 10, "consume_seconds": 3.0, "dispatch_seconds": 1.0}
    assert run.layer_metrics(NAMES, {"report": old}) == {}


def test_traced_tiny_run_carries_them(run_tiny):
    result = run_tiny(trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert {n for n, _ in NAMES} <= set(metrics)
    assert 0 < metrics["embed.crop_fill"]["value"] <= 100
    assert metrics["loop.write_ms_per_block"]["value"] > 0
    assert metrics["loop.assemble_ms_per_block"]["value"] > 0
