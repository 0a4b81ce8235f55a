"""Hand-written CUDA kernels of the port (``*.cu`` sources in this folder).

``build.load(name)`` compiles ``<name>.cu`` with ``nvcc`` at first use and
binds its ``extern "C"`` launcher through ``ctypes``. Nothing here runs at
import time, so a machine without ``nvcc`` imports the package fine.
"""
