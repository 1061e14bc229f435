"""The device's idle share over the traced frames of the SPC trace, under
the profiler: 100 x (1 - busy / window).  The trace's host syncs show
here."""


def read(record):
    if not record or not record['ops'] or record['window_s'] <= 0:
        return None
    return 100. * (1. - record['busy_s'] / record['window_s'])
