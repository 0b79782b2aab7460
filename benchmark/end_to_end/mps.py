"""Megapixels per second: the luma width x height of every image decoded in
the window, over the window's seconds (from the first request's send to
the last answer)."""


def read(rec):
    return rec.pixels / rec.window_s / 1e6
