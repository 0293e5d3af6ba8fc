from .progressor import Progressor
from .daemons import PressWorker, ScannerDaemon, launch_scanner, press

__all__ = ["Progressor", "PressWorker", "ScannerDaemon", "launch_scanner",
           "press"]
