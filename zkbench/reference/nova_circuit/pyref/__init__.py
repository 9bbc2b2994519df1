"""Field, curve and MiMC oracle (a copy of the port's `pyref`, G1 and Grumpkin only)."""

from .field import Fq, Fr, PrimeField
from .curve import AffinePoint, CurveSpec, G1_SPEC, GRUMPKIN_SPEC, ProjectivePoint
from .mimc import Mimc, MimcRO, mimc_constants
