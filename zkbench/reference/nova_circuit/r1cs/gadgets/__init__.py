from .binary import BinaryAssignment
from .field import FieldAssignment
from .curve import PointAssignment

__all__ = ["BinaryAssignment", "FieldAssignment", "PointAssignment"]
