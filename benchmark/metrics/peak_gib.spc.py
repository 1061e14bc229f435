"""The device's peak allocated memory over set-up and the window
(``torch.cuda.max_memory_allocated``), GiB."""


def read(record):
    if not record or 'memory_peak_bytes' not in record:
        return None
    return record['memory_peak_bytes'] / 2 ** 30
