"""The shared launch-width alignment (tracer.aligned_chunk_rows /
aligned_width): chunked launch widths flatten to a multiple of
LAUNCH_ALIGN lanes."""

from pyrite_tpu.tracer import LAUNCH_ALIGN, aligned_chunk_rows, aligned_width


def test_aligned_chunk_rows_rounds_down_on_invariant():
    for unit in (1, 2, 7, 128, 257, 1024, 1536):
        for cap in (1, 5, 1000, 1024, 262144, 1020):
            rows = aligned_chunk_rows(cap, unit)
            assert rows * unit % LAUNCH_ALIGN == 0
            assert rows >= 1
            # never exceeds the cap unless the minimum legal width does
            k = LAUNCH_ALIGN * unit // __import__("math").gcd(unit, LAUNCH_ALIGN) // unit
            assert rows <= max(cap, k)


def test_aligned_width_rounds_up_on_invariant():
    for unit in (1, 2, 7, 128, 257, 1024):
        for width in (0, 1, 1000, 1024, 1025, 262140):
            w = aligned_width(width, unit)
            assert w * unit % LAUNCH_ALIGN == 0
            assert w >= max(width, 1)
            # minimality: one aligned step below would violate the bound
            k = w - LAUNCH_ALIGN // __import__("math").gcd(unit, LAUNCH_ALIGN)
            assert k < max(width, 1)


def test_dragon_crash_width_is_corrected():
    # the historical crash: 1020 rows x 257 slots = 262140 lanes (unaligned)
    rows = aligned_chunk_rows(1020, 257)
    assert rows * 257 % LAUNCH_ALIGN == 0
    assert rows <= 1024  # stays near the cap, not a huge overshoot
