"""Published peaks of one NVIDIA H100 SXM card and the bound a kernel's
roofline share is taken against.

NVIDIA's data sheet, dense rates at the 700 W power limit: 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores.  A card set below
700 W runs slower than these peaks; every share is printed beside the
card's ``power.limit`` (:func:`~benchmark.harness.env.card_info`).
"""

__all__ = ['HBM_BYTES_PER_S', 'FP32_FLOP_PER_S', 'bound_s', 'share']

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(nbytes, flops):
    """The least time the card could take for ``nbytes`` moved and
    ``flops`` float32 operations: the larger of the two over their peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def share(nbytes, flops, seconds):
    """The bound as a percentage of ``seconds`` measured, or None where
    nothing was measured or nothing counted."""
    if not seconds or seconds <= 0 or (nbytes <= 0 and flops <= 0):
        return None
    return 100. * bound_s(nbytes, flops) / seconds
