"""The device's idle share over the traced block of the DIB-R fit, under
the profiler (whose cost per launch lies inside the window): 100 x (1 -
busy / window); on four cards rank 0's."""


def read(record):
    if not record or not record['ops'] or record['window_s'] <= 0:
        return None
    return 100. * (1. - record['busy_s'] / record['window_s'])
