from .dcp import DcpReader, DcpWriter, read_dcp_profiles

__all__ = ["DcpReader", "DcpWriter", "read_dcp_profiles"]
