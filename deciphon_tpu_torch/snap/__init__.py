from .match import Match, MatchList
from .prod import Prod, ProdList
from .snap_file import SnapFile, make_snap_archive, read_snap

__all__ = ["Match", "MatchList", "Prod", "ProdList", "SnapFile",
           "make_snap_archive", "read_snap"]
