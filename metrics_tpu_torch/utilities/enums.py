"""String enums used across the library.

Counterpart of ``metrics_tpu/utilities/enums.py``, copied: comparisons are
case-insensitive and tolerate raw strings or ``None`` so user-facing kwargs
stay plain strings.
"""
from enum import Enum
from typing import Optional, Union


class EnumStr(str, Enum):
    """A ``str``-valued Enum with case-insensitive lookup and comparison."""

    @classmethod
    def from_str(cls, value: str) -> Optional["EnumStr"]:
        try:
            return cls[str(value).replace(" ", "_").replace("-", "_").upper()]
        except KeyError:
            return None

    def __eq__(self, other: Union[str, "EnumStr", None]) -> bool:
        if isinstance(other, Enum):
            other = other.value
        # str(None) == "none" intentionally matches the NONE member, so users
        # may spell the no-averaging mode either average=None or average="none"
        return self.value.lower() == str(other).lower()

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return hash(self.value.lower())


class DataType(EnumStr):
    """The four canonical classification input cases."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Class-averaging modes for classification metrics."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """How the extra sample dimension is handled for multi-dim multi-class inputs."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"
