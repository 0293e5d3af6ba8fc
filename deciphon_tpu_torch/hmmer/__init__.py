from .forward import AminoForwardScorer, NativeConfirmer
from .h3result import H3Result

__all__ = ["AminoForwardScorer", "NativeConfirmer", "H3Result"]
