from .mesh import AXIS, make_mesh, make_mesh_2d
from .strategies import (
    STRATEGIES, Auto, ColumnWise, Library, NonZeroElement, RowWise,
    Sequential, Strategy, get_strategy,
)
from .banded_strategy import BandedRowWise
from .grid2d import Grid2D
from .windowed_strategy import WindowedRowWise

__all__ = [
    "AXIS", "make_mesh", "make_mesh_2d",
    "STRATEGIES", "Auto", "BandedRowWise",
    "WindowedRowWise", "ColumnWise", "Grid2D",
    "Library", "NonZeroElement", "RowWise", "Sequential", "Strategy",
    "get_strategy",
]
