from .binary import BinaryAssignment
from .field import FieldAssignment

__all__ = ["BinaryAssignment", "FieldAssignment"]
