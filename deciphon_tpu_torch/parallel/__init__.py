from .multidevice import MESH_AXIS, MultiDevicePairScorer, make_mesh

__all__ = ["MESH_AXIS", "MultiDevicePairScorer", "make_mesh"]
