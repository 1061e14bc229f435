"""Where the port's entry points run: the card, unless the caller asks.

An entry point takes ``device=None``.  It runs on ``device`` when one is
given, else on the device of its tensor inputs, else on CUDA.  With no card
and nothing that asks for another device it raises: there is no silent CPU
path, a caller that wants the CPU passes ``device='cpu'`` (or CPU tensors).
"""

import torch

__all__ = ['entry_device']


def entry_device(device=None, *inputs):
    """The device an entry point runs on.

    Args:
        device: what the caller asked for, or None.
        inputs: the entry point's array inputs; the first that is a tensor
            gives the device when ``device`` is None.  numpy arrays and
            lists give none.

    Raises:
        RuntimeError: the device is CUDA and no CUDA card is available.
    """
    if device is None:
        device = next((x.device for x in inputs if torch.is_tensor(x)),
                      'cuda')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'kaolin_tpu_torch runs on the CUDA card unless asked otherwise, '
            'and torch.cuda.is_available() is False: pass device="cpu" (or '
            'CPU tensors) to run on the CPU')
    return device
