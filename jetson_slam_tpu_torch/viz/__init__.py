from .frame_drawer import FrameDrawer
from .map_drawer import MapDrawer
from .viewer import Viewer

__all__ = ["FrameDrawer", "MapDrawer", "Viewer"]
