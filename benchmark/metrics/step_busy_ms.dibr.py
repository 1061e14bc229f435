"""Device busy time per step of the DIB-R fit: the union of the device
operations' intervals over the traced block, over its steps (on four
cards, rank 0's)."""


def read(record):
    if not record or not record['ops'] or not record['units']:
        return None
    return record['busy_s'] / record['units'] * 1e3
