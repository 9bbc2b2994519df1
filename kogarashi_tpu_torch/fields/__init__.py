"""Field layer: constants and host encoding (`spec`), plain-torch Montgomery
arithmetic (`mont`)."""

from .spec import FQ, FR, FieldSpec

__all__ = ["FQ", "FR", "FieldSpec"]
