"""The roofline count from shapes alone."""

from portbench.roofline import bound_ms


def test_fp32_scan_of_the_flat_cells_is_4771_ms():
    ms, by = bound_ms("f32", 1024, 1_000_000, 768, 10)
    assert by == "operations"
    assert round(ms, 3) == 4.771


def test_a_narrow_scan_is_bound_by_bytes():
    ms, by = bound_ms("s8", 1, 1_000_000, 768, 10)
    assert by == "bytes"
    assert abs(ms - 1e3 * ((1 + 1_000_000) * 768 + 80) / 3.35e12) < 1e-12
