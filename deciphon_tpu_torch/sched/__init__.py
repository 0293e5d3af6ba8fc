from .server import SchedServer
from .settings import SchedSettings

__all__ = ["SchedServer", "SchedSettings"]
