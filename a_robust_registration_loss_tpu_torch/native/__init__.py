"""Native (C++) runtime components of the port, loaded through ctypes.

- ``objio_native``: fast OBJ point-cloud IO (``objio.cpp``), built with g++
  on first use into ``build/torch_native/``; ``data/objio.py`` keeps the
  pure-Python path when it is not built.
"""
