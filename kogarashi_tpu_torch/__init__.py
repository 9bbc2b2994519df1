"""kogarashi_tpu_torch — Groth16, Nova and RedDSA on PyTorch and hand-written CUDA.

A port of `kogarashi_tpu` (JAX + Pallas) to PyTorch with CUDA C++ kernels for
Hopper (sm_90a). `kogarashi_tpu` stays the reference; this package imports
nothing of it and keeps its own copies of what it uses (`constants`,
`errors`, `pyref`, `r1cs`). Its entry points run on the card unless a caller
passes `device="cpu"` (`devices.py`).

Data layout, everywhere: a field element is 8 little-endian 32-bit words in
Montgomery form with R = 2^256, stored limb-major as int32 tensors holding
the bit pattern, shaped (8 * ext, ...): 8 words for Fq, Fr and BLS12-381's
Fr, 16 for Fq2 (c0 then c1). Every device op returns canonical values in
[0, p).
"""

__version__ = "0.1.0"
