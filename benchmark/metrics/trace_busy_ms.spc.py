"""Device busy time per frame of the SPC trace: the union of the device
operations' intervals over the traced frames, over their number."""


def read(record):
    if not record or not record['ops'] or not record['units']:
        return None
    return record['busy_s'] / record['units'] * 1e3
