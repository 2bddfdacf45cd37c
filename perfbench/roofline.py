"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W power limit) and the bytes the dequant kernel has to move in a
step.

float32 runs outside the tensor cores (the program keeps TF32 off);
bfloat16 on them. The dequant kernel reads one uint8 and writes one
float32 per element. In a step its uint8 input is the batch that the row
gather of a resident split, or the host copy of a shipped one, wrote just
before it, and the kernel reads it back from L2 (50 MB; a batch of 256
images at 64 px is 3.1 MB). Only its float32 output has to go out to
HBM, so its least time in the step is 4 bytes an element at the HBM
rate. (Alone, with L2 cold, the input comes from HBM too: 5 bytes an
element, as the program's ``time_kernels.py`` counts.)
"""

from __future__ import annotations

PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
HBM_BYTES_PER_S = 3.35e12
#: bytes an element that a step's dequant moves through HBM: the float32
#: it writes
DEQUANT_HBM_BYTES_PER_ELEMENT = 4


def peak_flops(compute_dtype: str) -> float:
    return PEAK_FLOPS[compute_dtype]


def dequant_bytes(elements: int) -> int:
    return DEQUANT_HBM_BYTES_PER_ELEMENT * elements


def dequant_floor_s(elements: int) -> float:
    """The least time dequantizing `elements` in a step can take."""
    return dequant_bytes(elements) / HBM_BYTES_PER_S
