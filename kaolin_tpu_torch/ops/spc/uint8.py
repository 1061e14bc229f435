"""uint8 bit manipulation for octree bytes.

Port of ``kaolin_tpu/ops/spc/uint8.py``.  Bit 0 first, as in the reference;
the popcount is a 256-entry table lookup.
"""

import torch

__all__ = ['uint8_to_bits', 'bits_to_uint8', 'uint8_bits_sum']

_SHIFTS = torch.arange(8, dtype=torch.int32)
_POPCOUNT = torch.tensor([bin(i).count('1') for i in range(256)],
                         dtype=torch.int32)


def popcount_table(device):
    """The (256,) int32 popcount table on ``device``."""
    return _POPCOUNT.to(device)


def uint8_to_bits(uint8_t):
    """Unpack uint8 values to 8 booleans (bit 0 first): (...,) -> (..., 8)."""
    x = uint8_t.to(torch.int32)
    return ((x[..., None] >> _SHIFTS.to(x.device)) & 1).bool()


def bits_to_uint8(bool_t):
    """Pack (..., 8) booleans into uint8 (bit 0 first)."""
    vals = (bool_t.to(torch.int32) << _SHIFTS.to(bool_t.device)).sum(dim=-1)
    return vals.to(torch.uint8)


def uint8_bits_sum(uint8_t):
    """Popcount of each byte, int32."""
    return popcount_table(uint8_t.device)[uint8_t.long()]
