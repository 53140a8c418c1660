"""The per-layer readers, on a made-up traced window: what they read,
and nothing where there is nothing to read."""
import pytest

from portbench import film, run


def ctx(**over):
    c = {"report": {"blocks": 10, "fetch_seconds": 0.5, "upload_seconds": 1,
                    "dispatch_seconds": 2, "consume_seconds": 0.5,
                    "flush_dispatch_seconds": 0.5,
                    "consume_write_seconds": 0.3,
                    "consume_assemble_seconds": 0.1, "embed_crops": 300,
                    "embed_slots": 320},
         "trace": {"window_s": 2.0, "busy_s": 1.5,
                   "kernels": {"void hist256_kernel<RgbSrc>(...)": 0.0008,
                               "cum_lookup_kernel(...)": 0.0008,
                               "tracker_scan_kernel(ScanArgs, int)": 0.0032,
                               "sm80_xmma_fprop": 1.0},
                   "ranges": {"portbench.detector": {"calls": 8,
                                                     "device_s": 0.96},
                              "portbench.embed": {"calls": 2,
                                                  "device_s": 0.3}}},
         "window": {"blocks": 8, "crops": 300, "crop_slots": 320,
                    "dispatches": 2},
         "block_frames": 128, "device_kind": "NVIDIA H100 80GB HBM3",
         "detector_flops_per_frame": 16.6e9,
         "embed_flops_per_crop": 11.3e9,
         "scene_bytes_per_block": 415e6,
         "peaks": film.load_json(".", "peaks")}
    c.update(over)
    return c


def names():
    return [(m["name"], m["unit"]) for m in film.benchmark()["per_layer"]]


def test_every_metric_has_a_reader_and_reads():
    got = run.layer_metrics(names(), ctx())
    assert set(got) == {n for n, _ in names()}
    assert got["loop.fetch_wait_ms_per_block"]["value"] == pytest.approx(50)
    assert got["loop.host_ms_per_block"]["value"] == pytest.approx(300)
    assert got["loop.upload_ms_per_block"]["value"] == pytest.approx(100)
    assert got["detector.device_ms_per_block"]["value"] == \
        pytest.approx(120)
    assert got["embed.device_ms_per_crop"]["value"] == pytest.approx(1.0)
    assert got["tracker.scan_ms_per_block"]["value"] == pytest.approx(0.4)
    assert got["device.idle_share"]["value"] == pytest.approx(25)
    share = 100 * 415e6 / 3.35e12 / 0.0002
    assert got["equalize_roofline"]["value"] == pytest.approx(share)
    flops = 8 * 128 * 16.6e9 + 300 * 11.3e9
    assert got["mfu_f32"]["value"] == pytest.approx(
        100 * flops / 2.0 / 67e12)
    assert got["loop.write_ms_per_block"]["value"] == pytest.approx(30)
    assert got["loop.assemble_ms_per_block"]["value"] == pytest.approx(10)
    assert got["embed.crop_fill"]["value"] == pytest.approx(93.75)


def test_nothing_to_read_gives_no_metric():
    empty = ctx(trace={"window_s": 2.0, "busy_s": 0.0, "kernels": {},
                       "ranges": {"portbench.detector": {"calls": 0,
                                                         "device_s": 0.0},
                                  "portbench.embed": {"calls": 0,
                                                      "device_s": 0.0}}},
                window={"blocks": 8, "crops": 0, "crop_slots": 0,
                        "dispatches": 0},
                device_kind="cpu")
    got = run.layer_metrics(names(), empty)
    # the window's report still reads; the trace has nothing
    assert set(got) == {"loop.fetch_wait_ms_per_block",
                        "loop.host_ms_per_block", "loop.upload_ms_per_block",
                        "loop.write_ms_per_block",
                        "loop.assemble_ms_per_block", "embed.crop_fill"}
